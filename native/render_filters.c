/* Host render-pipeline filters: EPF passes and 3x3 Gaborish.
 *
 * Covers the role of the reference's SIMD edge-preserving filter
 * (lib/jxl/epf.cc + render_pipeline/stage_epf.cc) and Gaborish stage
 * (stage_gaborish.cc) for the host decode path, with the same
 * restructured-SAD algorithm the device pipeline uses
 * (libjxl_tpu/parallel/sharding.py): every EPF pass is expressed over
 * symmetric neighbor PAIRS +/-(dy,dx).  For each pair one weighted
 * absolute-difference plane D(y,x) = sum_c cs[c]*|X_c(y,x) -
 * X_c(y+dy,x+dx)| is computed once on a symmetric-padded buffer; the
 * plus-shaped SAD of the reference's pass 0/1 is then a 5-point
 * convolution of D, and BOTH neighbors of the pair read the same plane
 * (sad for -n at q == plusconv(D)(q-n)).  This does ~6x less arithmetic
 * than the textbook per-neighbor SAD and vectorizes cleanly along rows,
 * while staying numerically identical (in f32) to evaluating each
 * neighbor independently on the padded image, i.e. to the Python host
 * path's np.pad(mode="symmetric") semantics.
 *
 * Plain C interface for ctypes; built into _jxl_native.so.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define PAD 5 /* covers |neighbor| <= 2 + plus reach 1 + D extent 2 */

/* symmetric mirror: ... 1 0 | 0 1 2 ... (valid for |i| < 2n) */
static inline int64_t mirror_idx(int64_t i, int64_t n) {
    if (i < 0) return -i - 1;
    if (i >= n) return 2 * n - 1 - i;
    return i;
}

/* (h, w) -> (h + 2*PAD, w + 2*PAD) symmetric-padded copy */
static void pad_plane(const float *src, int64_t h, int64_t w, float *dst) {
    int64_t wp = w + 2 * PAD;
    for (int64_t y = -PAD; y < h + PAD; y++) {
        const float *row = src + mirror_idx(y, h) * w;
        float *o = dst + (y + PAD) * wp;
        for (int64_t x = -PAD; x < 0; x++) o[x + PAD] = row[-x - 1];
        memcpy(o + PAD, row, sizeof(float) * w);
        for (int64_t x = w; x < w + PAD; x++) o[x + PAD] = row[2 * w - 1 - x];
    }
}

/* One EPF pass over symmetric neighbor pairs.
 *
 * xyb:        (3, h, w) float32, C-contiguous input planes
 * out:        (3, h, w) float32 output (may NOT alias xyb)
 * inv_sigma:  (h, w) per-pixel 1/sigma (negative; < min_sigma -> copy)
 * sad_mul:    (h, w) per-pixel border multiplier
 * cs:         channel_scale[3]
 * pairs_dy/dx[npairs]: one entry per +/- pair
 * use_plus:   nonzero -> plus-shaped SAD (reference passes 0 and 1)
 * scale:      sigma_scale * 1.65 premultiplier
 * Returns 0, or -1 on allocation failure / bad size.
 */
typedef struct {
    const float *xyb, *xp, *inv_sigma, *inv, *cs;
    float *out;
    int64_t h, w, y0, y1;
    const int *pairs_dy, *pairs_dx;
    int npairs, use_plus;
    float min_sigma;
    int rc;
} EpfJob;

/* One output row band [y0, y1). D and P are computed thread-locally
 * with a 3-row halo, so bands are fully independent — no barriers, no
 * shared scratch. Each band runs all pair passes then normalizes. */
static void epf_band(EpfJob *j) {
    int64_t h = j->h, w = j->w, n = h * w;
    int64_t wp = w + 2 * PAD, np_ = (h + 2 * PAD) * wp;
    int64_t bh = j->y1 - j->y0;
    /* band D/P rows: padded coords [y0+PAD-3, y1+PAD+3) */
    int64_t db0 = j->y0 + PAD - 3, dbh = bh + 6;
    float *dbuf = malloc(sizeof(float) * dbh * wp);
    float *pbuf = malloc(sizeof(float) * dbh * wp);
    float *num = malloc(sizeof(float) * 3 * bh * w);
    float *den = malloc(sizeof(float) * bh * w);
    if (!dbuf || !pbuf || !num || !den) {
        free(dbuf); free(pbuf); free(num); free(den);
        j->rc = -1;
        return;
    }
    for (int c = 0; c < 3; c++)
        memcpy(num + c * bh * w, j->xyb + c * n + j->y0 * w,
               sizeof(float) * bh * w);
    for (int64_t i = 0; i < bh * w; i++) den[i] = 1.0f;
    const float *xp = j->xp;
    int64_t d_lo = PAD - 3; /* valid x range of D, as in global coords */

    for (int p = 0; p < j->npairs; p++) {
        int dy = j->pairs_dy[p], dx = j->pairs_dx[p];
        /* D(y,x) = sum_c cs[c] * |Xp_c(y,x) - Xp_c(y+dy,x+dx)| */
        for (int64_t yy = 0; yy < dbh; yy++) {
            int64_t y = db0 + yy; /* padded coords */
            float *o = dbuf + yy * wp;
            for (int c = 0; c < 3; c++) {
                const float *r = xp + c * np_ + y * wp;
                const float *r2 = xp + c * np_ + (y + dy) * wp + dx;
                float csc = j->cs[c];
                if (c == 0)
                    for (int64_t x = d_lo; x < wp - d_lo; x++) {
                        float d = r[x] - r2[x];
                        o[x] = csc * (d < 0 ? -d : d);
                    }
                else
                    for (int64_t x = d_lo; x < wp - d_lo; x++) {
                        float d = r[x] - r2[x];
                        o[x] += csc * (d < 0 ? -d : d);
                    }
            }
        }
        const float *sad = dbuf;
        int64_t sad_base = db0;
        if (j->use_plus) {
            for (int64_t yy = 1; yy + 1 < dbh; yy++) {
                const float *r0 = dbuf + (yy - 1) * wp;
                const float *r1 = dbuf + yy * wp;
                const float *r2 = dbuf + (yy + 1) * wp;
                float *o = pbuf + yy * wp;
                for (int64_t x = d_lo + 1; x < wp - d_lo - 1; x++)
                    o[x] = r1[x] + r0[x] + r2[x] + r1[x - 1] + r1[x + 1];
            }
            sad = pbuf;
        }
        /* neighbor +(dy,dx): weight from sad(q), sample Xp(q+n);
         * neighbor -(dy,dx): weight from sad(q-n), sample Xp(q-n). */
        for (int64_t y = j->y0; y < j->y1; y++) {
            const float *sad_r = sad + (y + PAD - sad_base) * wp + PAD;
            const float *sad_m =
                sad + (y - dy + PAD - sad_base) * wp + PAD - dx;
            const float *inv_r = j->inv + y * w;
            float *den_r = den + (y - j->y0) * w;
            float *num_b = num + (y - j->y0) * w;
            for (int64_t x = 0; x < w; x++) {
                float w1 = 1.0f + sad_r[x] * inv_r[x];
                float w2 = 1.0f + sad_m[x] * inv_r[x];
                if (w1 < 0.0f) w1 = 0.0f;
                if (w2 < 0.0f) w2 = 0.0f;
                den_r[x] += w1 + w2;
                for (int c = 0; c < 3; c++) {
                    const float *pc = xp + c * np_;
                    num_b[c * bh * w + x] +=
                        w1 * pc[(y + dy + PAD) * wp + x + dx + PAD]
                        + w2 * pc[(y - dy + PAD) * wp + x - dx + PAD];
                }
            }
        }
    }
    for (int c = 0; c < 3; c++)
        for (int64_t y = j->y0; y < j->y1; y++)
            for (int64_t x = 0; x < w; x++) {
                int64_t i = y * w + x;
                int64_t b = (y - j->y0) * w + x;
                j->out[c * n + i] = (j->inv_sigma[i] < j->min_sigma)
                                        ? j->xyb[c * n + i]
                                        : num[c * bh * w + b] / den[b];
            }
    free(dbuf); free(pbuf); free(num); free(den);
    j->rc = 0;
}

static void *epf_worker(void *arg) {
    epf_band((EpfJob *)arg);
    return NULL;
}

#include <pthread.h>
#define EPF_MAX_THREADS 16

int epf_pass_f32(const float *xyb, float *out, int64_t h, int64_t w,
                 const float *inv_sigma, const float *sad_mul,
                 const float *cs, const int *pairs_dy, const int *pairs_dx,
                 int npairs, int use_plus, float scale, float min_sigma,
                 int n_threads) {
    if (h < PAD || w < PAD) return -1; /* caller falls back to Python */
    int64_t n = h * w;
    int64_t wp = w + 2 * PAD, np_ = (h + 2 * PAD) * wp;
    float *xp = malloc(sizeof(float) * 3 * np_);
    float *inv = malloc(sizeof(float) * n);
    if (!xp || !inv) {
        free(xp); free(inv);
        return -1;
    }
    for (int c = 0; c < 3; c++) pad_plane(xyb + c * n, h, w, xp + c * np_);
    for (int64_t i = 0; i < n; i++) inv[i] = inv_sigma[i] * sad_mul[i] * scale;

    int nb = n_threads;
    if (nb < 1) nb = 1;
    if (nb > EPF_MAX_THREADS) nb = EPF_MAX_THREADS;
    if (nb > (int)(h / 8)) nb = (int)(h / 8) > 0 ? (int)(h / 8) : 1;
    EpfJob jobs[EPF_MAX_THREADS];
    pthread_t tids[EPF_MAX_THREADS];
    for (int t = 0; t < nb; t++) {
        jobs[t] = (EpfJob){xyb, xp, inv_sigma, inv, cs, out, h, w,
                           h * t / nb, h * (t + 1) / nb,
                           pairs_dy, pairs_dx, npairs, use_plus,
                           min_sigma, 0};
    }
    int spawned = 0;
    for (int t = 1; t < nb; t++) {
        if (pthread_create(&tids[t], NULL, epf_worker, &jobs[t])) break;
        spawned = t;
    }
    epf_band(&jobs[0]);
    for (int t = 1; t <= spawned; t++) pthread_join(tids[t], NULL);
    int rc = 0;
    for (int t = 0; t < nb; t++)
        if (t <= spawned || t == 0)
            if (jobs[t].rc != 0) rc = -1;
    /* bands beyond `spawned` never ran if creates failed */
    if (spawned + 1 < nb) {
        for (int t = spawned + 1; t < nb; t++) {
            epf_band(&jobs[t]);
            if (jobs[t].rc != 0) rc = -1;
        }
    }
    free(xp); free(inv);
    return rc;
}

/* Fused sRGB transfer + uint8 quantization: out[i] = #{j: thr[j] <
 * lin[i]} over the 255 linear-domain decision points of
 * round(srgb(x)*255), matching np.searchsorted(side="left").
 *
 * The minimum spacing of the thresholds is 1/(255*12.92) = 3.03e-4
 * (the sRGB transfer's steepest linear segment), so a 4096-bucket
 * lookup (bucket width 2.44e-4 < min spacing) narrows the lower bound
 * to {hint, hint+1}: one table read + one fixup compare per pixel.
 * hint[k] = #{j: thr[j] < k/4096}; thr must carry a +inf sentinel at
 * index 255 so the fixup read is safe when hint = 255. */
void srgb_u8_f32(const float *lin, uint8_t *out, int64_t n,
                 const float *thr, const uint8_t *hint) {
    const float buckets = 4096.0f;
    for (int64_t i = 0; i < n; i++) {
        float v = lin[i];
        int k = (int)(v * buckets);
        if (k < 0) k = 0;
        else if (k > 4095) k = 4095;
        unsigned lo = hint[k];
        lo += (thr[lo] < v);
        out[i] = (uint8_t)lo;
    }
}

/* 3x3 convolution with symmetric border mirroring (Gaborish stage).
 * img: (h, w) float32; kern: 9 floats row-major; out: (h, w). */
int conv3x3_sym_f32(const float *img, float *out, int64_t h, int64_t w,
                    const float *kern) {
    if (h < 1 || w < 2) return -1;
    for (int64_t y = 0; y < h; y++) {
        const float *r0 = img + mirror_idx(y - 1, h) * w;
        const float *r1 = img + y * w;
        const float *r2 = img + mirror_idx(y + 1, h) * w;
        float *o = out + y * w;
        for (int64_t x = 1; x + 1 < w; x++) {
            o[x] = kern[0] * r0[x - 1] + kern[1] * r0[x] + kern[2] * r0[x + 1]
                 + kern[3] * r1[x - 1] + kern[4] * r1[x] + kern[5] * r1[x + 1]
                 + kern[6] * r2[x - 1] + kern[7] * r2[x] + kern[8] * r2[x + 1];
        }
        /* border columns: symmetric mirror (x=-1 -> 0, x=w -> w-1) */
        o[0] = kern[0] * r0[0] + kern[1] * r0[0] + kern[2] * r0[1]
             + kern[3] * r1[0] + kern[4] * r1[0] + kern[5] * r1[1]
             + kern[6] * r2[0] + kern[7] * r2[0] + kern[8] * r2[1];
        o[w - 1] = kern[0] * r0[w - 2] + kern[1] * r0[w - 1]
                 + kern[2] * r0[w - 1] + kern[3] * r1[w - 2]
                 + kern[4] * r1[w - 1] + kern[5] * r1[w - 1]
                 + kern[6] * r2[w - 2] + kern[7] * r2[w - 1]
                 + kern[8] * r2[w - 1];
    }
    return 0;
}

/* Fused DCT8 dequantization for the host render path: for each listed
 * 8x8 block, gather its wide-layout coefficients from the dense
 * image-layout planes, apply AdjustQuantBias (quantizer-inl.h:34-62),
 * the dequant matrices, the global/per-block scale, chroma-from-luma,
 * and the DC (LLF) overwrite — emitting float32 (n, 3, 64) ready for
 * the batched IDCT. Fuses five vectorized numpy passes into one sweep.
 *
 * qimg: (3, H, W) int32 image-layout coefficients (W = row stride)
 * ys/xs: block coordinates (in blocks); qf: (nby, nbx) raw quant field
 * dm: (3, 64) dequant matrices (wide layout)
 * x_cc/b_cc: per-block CfL factors (n)
 * dc: (3, nby, nbx) float32 DC image
 * biases: {bias_x, bias_y, bias_b, bias_general}
 */
void dequant_dct8_f32(const int32_t *qimg, int64_t H, int64_t W,
                      const int64_t *ys, const int64_t *xs, int64_t n,
                      const int32_t *qf, int64_t nby, int64_t nbx,
                      const float *dm, float inv_gs, float x_dm_mult,
                      float b_dm_mult, const float *x_cc,
                      const float *b_cc, const float *dc,
                      const float *biases, float *out) {
    const int64_t plane = H * W;
    for (int64_t i = 0; i < n; i++) {
        int64_t by = ys[i], bx = xs[i];
        const int64_t base = by * 8 * W + bx * 8;
        const float scaled = inv_gs / (float)qf[by * nbx + bx];
        const float sx = scaled * x_dm_mult, sb = scaled * b_dm_mult;
        const float xcc = x_cc[i], bcc = b_cc[i];
        float *o = out + i * 3 * 64;
        for (int r = 0; r < 8; r++) {
            const int32_t *q0 = qimg + base + r * W;           /* X  */
            const int32_t *q1 = qimg + plane + base + r * W;   /* Y  */
            const int32_t *q2 = qimg + 2 * plane + base + r * W;
            for (int k8 = 0; k8 < 8; k8++) {
                int k = r * 8 + k8;
                int32_t vy = q1[k8], vx = q0[k8], vb = q2[k8];
                float fy = (vy == 0) ? 0.0f
                           : (vy == 1) ? biases[1]
                           : (vy == -1) ? -biases[1]
                           : (float)vy - biases[3] / (float)vy;
                float fx = (vx == 0) ? 0.0f
                           : (vx == 1) ? biases[0]
                           : (vx == -1) ? -biases[0]
                           : (float)vx - biases[3] / (float)vx;
                float fb = (vb == 0) ? 0.0f
                           : (vb == 1) ? biases[2]
                           : (vb == -1) ? -biases[2]
                           : (float)vb - biases[3] / (float)vb;
                float dqy = fy * dm[64 + k] * scaled;
                o[64 + k] = dqy;
                o[k] = fx * dm[k] * sx + xcc * dqy;
                o[128 + k] = fb * dm[128 + k] * sb + bcc * dqy;
            }
        }
        /* LLF: DC overwrites coefficient 0 */
        o[0] = dc[by * nbx + bx];
        o[64] = dc[nby * nbx + by * nbx + bx];
        o[128] = dc[2 * nby * nbx + by * nbx + bx];
    }
}
