/* Native hot loop: VarDCT AC-group coefficient decode.
 *
 * Mirrors DecodeACVarBlock (lib/jxl/dec_group.cc:453-530) and the context
 * model of lib/jxl/ac_context.h: per block, read the nonzero count in a
 * context predicted from the top/left blocks, then the zero-density-context
 * coefficient chain, scattering through the coefficient order LUT.
 *
 * Entropy decode on the host is bit-serial by construction; this replaces
 * the Python token loop (vardct/frame.py decode_ac_group) so a whole 256px
 * group decodes in one C call. Parallel work (dequant/IDCT/filters) runs
 * on the device.
 *
 * Built together with modular_decode.c into _jxl_native.so (see
 * libjxl_tpu/native_ext.py). Plain C interface for ctypes.
 */

#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>
#include <pthread.h>

#define ANS_LOG_TAB_SIZE 12
#define ANS_TAB_SIZE (1 << ANS_LOG_TAB_SIZE)
#define NONZERO_BUCKETS 37
#define ZERO_DENSITY_CONTEXT_COUNT 458

typedef struct {
  const uint8_t* data;
  size_t size;
  size_t pos;
  uint64_t buf;
  int bits;
} BitReaderV;

static inline void vbr_refill(BitReaderV* br) {
  if (br->pos + 8 <= br->size) {
    /* bulk refill: one unaligned 8-byte load instead of a byte loop */
    uint64_t chunk;
    memcpy(&chunk, br->data + br->pos, 8);
    int nbytes = (63 - br->bits) >> 3;
    br->buf |= chunk << br->bits;
    br->pos += (size_t)nbytes;
    br->bits += nbytes * 8;
    return;
  }
  while (br->bits <= 56) {
    uint64_t byte = br->pos < br->size ? br->data[br->pos] : 0;
    br->buf |= byte << br->bits;
    br->pos++;
    br->bits += 8;
  }
}

static inline uint32_t vbr_read(BitReaderV* br, int n) {
  if (n == 0) return 0;
  if (br->bits < n) vbr_refill(br);
  uint32_t v = (uint32_t)(br->buf & ((1ull << n) - 1));
  br->buf >>= n;
  br->bits -= n;
  return v;
}

typedef struct {
  const uint16_t* cutoff;
  const uint16_t* right;
  const uint16_t* freq0;
  const uint16_t* offsets1;
  const uint16_t* freq1;
  int log_alpha_size;
  const uint8_t* context_map;
  const uint32_t* cfg_split_exp;
  const uint32_t* cfg_msb;
  const uint32_t* cfg_lsb;
} AnsTablesV;

static inline uint32_t v_ans_read_symbol(const AnsTablesV* t, int cluster,
                                         uint32_t* state, BitReaderV* br) {
  uint32_t res = *state & (ANS_TAB_SIZE - 1);
  int las = t->log_alpha_size;
  int les = ANS_LOG_TAB_SIZE - las;
  uint32_t i = res >> les;
  uint32_t pos = res & ((1u << les) - 1);
  size_t base = (size_t)cluster << las;
  uint32_t cutoff = t->cutoff[base + i];
  uint32_t sym, off, freq;
  if (pos >= cutoff) {
    sym = t->right[base + i];
    off = t->offsets1[base + i] + pos;
    freq = t->freq1[base + i];
  } else {
    sym = i;
    off = pos;
    freq = t->freq0[base + i];
  }
  *state = freq * (*state >> ANS_LOG_TAB_SIZE) + off;
  if (*state < (1u << 16)) {
    *state = (*state << 16) | vbr_read(br, 16);
  }
  return sym;
}

/* Packed alias entry: one 8-byte load per symbol instead of five
 * scattered uint16 loads (dec_ans.h AliasTable::Entry analog).
 * Layout: [cutoff, right | (freq1 << ...)]... kept simple:
 * e[0]=cutoff, e[1]=right, e[2]=freq0, e[3]=offsets1 packed as 4x u16;
 * freq1 lives in a parallel array (still same cache line rate). */
typedef struct {
  uint16_t cutoff;
  uint16_t right;
  uint16_t freq0;
  uint16_t offsets1;
  uint16_t freq1;
  uint16_t pad[3];
} AliasEntryV;

static inline uint32_t v_ans_read_symbol_packed(
    const AliasEntryV* entries, int les, int cluster_shift_base,
    uint32_t* state, BitReaderV* br) {
  uint32_t res = *state & (ANS_TAB_SIZE - 1);
  uint32_t i = res >> les;
  uint32_t pos = res & ((1u << les) - 1);
  const AliasEntryV* e = entries + cluster_shift_base + i;
  int ge = pos >= e->cutoff;
  uint32_t sym = ge ? e->right : i;
  uint32_t off = ge ? (uint32_t)e->offsets1 + pos : pos;
  uint32_t freq = ge ? e->freq1 : e->freq0;
  *state = freq * (*state >> ANS_LOG_TAB_SIZE) + off;
  if (*state < (1u << 16)) {
    *state = (*state << 16) | vbr_read(br, 16);
  }
  return sym;
}

typedef struct {
  const AliasEntryV* entries;
  int log_alpha_size;
  const uint8_t* context_map;
  const uint32_t* cfg_split_exp;
  const uint32_t* cfg_msb;
  const uint32_t* cfg_lsb;
} AnsPackedV;

static inline uint32_t v_read_hybrid_uint_packed(const AnsPackedV* t,
                                                 int ctx, uint32_t* state,
                                                 BitReaderV* br) {
  int cluster = t->context_map[ctx];
  int les = ANS_LOG_TAB_SIZE - t->log_alpha_size;
  uint32_t token = v_ans_read_symbol_packed(
      t->entries, les, cluster << t->log_alpha_size, state, br);
  uint32_t split_exp = t->cfg_split_exp[cluster];
  uint32_t split_token = 1u << split_exp;
  if (token < split_token) return token;
  uint32_t msb = t->cfg_msb[cluster];
  uint32_t lsb = t->cfg_lsb[cluster];
  uint32_t nbits = split_exp - (msb + lsb) +
                   ((token - split_token) >> (msb + lsb));
  if (nbits > 31) return UINT32_MAX; /* saturate: callers bound-check */
  uint32_t low = token & ((1u << lsb) - 1);
  token >>= lsb;
  uint64_t bits = vbr_read(br, (int)nbits);
  uint64_t v = ((((uint64_t)(1u << msb) | (token & ((1u << msb) - 1)))
                 << nbits) |
                bits)
                   << lsb |
               low;
  /* values past uint32 wrapped before (diverging from the exact-int
   * Python fallback); saturate so the callers' range checks fire */
  return v > UINT32_MAX ? UINT32_MAX : (uint32_t)v;
}

static inline uint32_t v_read_hybrid_uint(const AnsTablesV* t, int ctx,
                                          uint32_t* state, BitReaderV* br) {
  int cluster = t->context_map[ctx];
  uint32_t token = v_ans_read_symbol(t, cluster, state, br);
  uint32_t split_exp = t->cfg_split_exp[cluster];
  uint32_t split_token = 1u << split_exp;
  if (token < split_token) return token;
  uint32_t msb = t->cfg_msb[cluster];
  uint32_t lsb = t->cfg_lsb[cluster];
  uint32_t nbits = split_exp - (msb + lsb) +
                   ((token - split_token) >> (msb + lsb));
  if (nbits > 31) return UINT32_MAX; /* saturate: callers bound-check */
  uint32_t low = token & ((1u << lsb) - 1);
  token >>= lsb;
  uint64_t bits = vbr_read(br, (int)nbits);
  uint64_t v = ((((uint64_t)(1u << msb) | (token & ((1u << msb) - 1)))
                 << nbits) |
                bits)
                   << lsb |
               low;
  /* values past uint32 wrapped before (diverging from the exact-int
   * Python fallback); saturate so the callers' range checks fire */
  return v > UINT32_MAX ? UINT32_MAX : (uint32_t)v;
}

/* ac_context.h:24-45 */
static const int32_t kCoeffFreqContext[64] = {
    0xBAD, 0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14,
    15,    15, 16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 21, 21, 22, 22,
    23,    23, 23, 23, 24, 24, 24, 24, 25, 25, 25, 25, 26, 26, 26, 26,
    27,    27, 27, 27, 28, 28, 28, 28, 29, 29, 29, 29, 30, 30, 30, 30};

static const int32_t kCoeffNumNonzeroContext[64] = {
    0xBAD, 0,   31,  62,  62,  93,  93,  93,  93,  123, 123, 123, 123,
    152,   152, 152, 152, 152, 152, 152, 152, 180, 180, 180, 180, 180,
    180,   180, 180, 180, 180, 180, 180, 206, 206, 206, 206, 206, 206,
    206,   206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206,
    206,   206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206};

/* Fill the strategy/origin/qf/sharpness maps from a decoded AC-metadata
 * stream (the per-pixel placement loop of dec_modular.cc:437-532).
 * acs_row/qf_row: int32[count]; sharp: int32[rh*rw];
 * strategy: int8 full-image map (nbx stride), initialized to -1;
 * origin: uint8; qf: int32; sharp_out: int8.
 * Geometry luts: cov_x/cov_y int32[27].
 * group_dim_blocks: AC-group size in blocks; a transform may not cross
 * an AC-group boundary (dec_modular.cc:515 "Invalid AC strategy"), and
 * enforcing it here also bounds every nzmap write in decode_ac_image.
 * Returns number of blocks consumed, or -1 on corruption. */
int place_ac_metadata(const int32_t* acs_row, const int32_t* qf_row,
                      int32_t count, const int32_t* sharp,
                      int x0, int y0, int rw, int rh,
                      int nbx_total, int nby_total, int group_dim_blocks,
                      const int32_t* cov_x, const int32_t* cov_y,
                      int quant_max,
                      int32_t* strategy, uint8_t* origin, int32_t* qf,
                      int32_t* sharp_out) {
  int num = 0;
  int gdim = group_dim_blocks;
  for (int iy = 0; iy < rh; iy++) {
    for (int ix = 0; ix < rw; ix++) {
      int x = x0 + ix, y = y0 + iy;
      int s = sharp[(size_t)iy * rw + ix];
      if (s < 0 || s >= 8) return -1;
      sharp_out[(size_t)y * nbx_total + x] = s;
      if (strategy[(size_t)y * nbx_total + x] >= 0) continue;
      if (num >= count) return -1;
      int raw = acs_row[num];
      if (raw < 0 || raw >= 27) return -1;
      int cx = cov_x[raw], cy = cov_y[raw];
      if (x + cx > nbx_total || y + cy > nby_total) return -1;
      if (x % gdim + cx > gdim || y % gdim + cy > gdim) return -1;
      int q = qf_row[num] + 1;
      if (q < 1) q = 1;
      if (q > quant_max) q = quant_max;
      for (int yy = 0; yy < cy; yy++)
        for (int xx = 0; xx < cx; xx++) {
          strategy[(size_t)(y + yy) * nbx_total + x + xx] = raw;
          qf[(size_t)(y + yy) * nbx_total + x + xx] = q;
        }
      origin[(size_t)y * nbx_total + x] = 1;
      num++;
    }
  }
  return num;
}

/* Whole-image AC decode for one pass: every group's section in one call,
 * coefficients written straight into the dense image-layout planes
 * (qimg[c][py * W + px]). Replaces the per-group Python dispatch.
 *
 * group_off/group_size: byte ranges of each group's section within data.
 * strategy/origin/qf: full-image block maps (see place_ac_metadata).
 * bctx_lut: int32[3 * 13 * (nqf + 1)]  ((c_idx * 13 + ord) * (nqf+1) + qfi)
 * qf_thr: int64[nqf] block-context qf thresholds.
 * ord_img_off: int64[27 * 3] offset into ord_img_flat per (strategy, c);
 * ord_img_flat: int32 image-relative offsets (dy * W + dx) per coeff k.
 * cov_x/cov_y/log2cb/ord_lut: int32[27] strategy geometry.
 * Returns 0, or (1000 + group) on a bad group. */
/* Shared read-only decode context for one pass over the group grid. */
typedef struct {
  const uint8_t* data;
  const uint64_t* group_off;
  const uint64_t* group_size;
  int n_groups, xsize_groups, group_dim_blocks;
  const AliasEntryV* entries;
  int log_alpha_size;
  const uint8_t* context_map;
  const uint32_t* cfg_split;
  const uint32_t* cfg_msb;
  const uint32_t* cfg_lsb;
  const int32_t* strategy;
  const uint8_t* origin;
  const int32_t* qf;
  int nby, nbx;
  const int32_t* bctx_lut;
  const int64_t* qf_thr;
  int nqf;
  const int64_t* ord_img_off;
  const int32_t* ord_img_flat;
  const int32_t* cov_x;
  const int32_t* cov_y;
  const int32_t* log2cb;
  const int32_t* ord_lut;
  int histo_bits, num_histograms, num_ac_ctx, num_ctxs, shift, W;
  int32_t* planes[3];
} AcImageCtx;

/* Decode one group's section into the dense planes. Returns 0 ok.
 * nzmap: caller scratch, int32[3 * gdim * gdim]. Groups touch disjoint
 * pixel ranges (transforms cannot cross group boundaries — enforced in
 * place_ac_metadata), so concurrent calls on different groups are safe. */
static int decode_one_ac_group_img(const AcImageCtx* cc, int g,
                                   int32_t* nzmap) {
  static const int kChanOrder[3] = {1, 0, 2};
  int gdim = cc->group_dim_blocks;
  int gx = g % cc->xsize_groups;
  int gy = g / cc->xsize_groups;
  int bx0 = gx * gdim;
  int by0 = gy * gdim;
  int bw = cc->nbx - bx0;
  if (bw > gdim) bw = gdim;
  int bh = cc->nby - by0;
  if (bh > gdim) bh = gdim;

  BitReaderV br;
  br.data = cc->data + cc->group_off[g];
  br.size = cc->group_size[g];
  br.pos = 0;
  br.buf = 0;
  br.bits = 0;
  int ctx_offset = 0;
  if (cc->histo_bits) {
    uint32_t sel = vbr_read(&br, cc->histo_bits);
    /* TOC-controlled selector must name an existing histogram set
     * (dec_frame.cc rejects selector >= num_histograms) */
    if (sel >= (uint32_t)cc->num_histograms) return 1;
    ctx_offset = (int)sel * cc->num_ac_ctx;
  }
  uint32_t state = vbr_read(&br, 32);
  memset(nzmap, 0, sizeof(int32_t) * 3 * bh * bw);
  AnsPackedV t = {cc->entries, cc->log_alpha_size, cc->context_map,
                  cc->cfg_split, cc->cfg_msb, cc->cfg_lsb};
  int nqf = cc->nqf, num_ctxs = cc->num_ctxs, shift = cc->shift;
  int W = cc->W, nbx = cc->nbx;

  for (int by = 0; by < bh; by++) {
    for (int bx = 0; bx < bw; bx++) {
      int aby = by0 + by, abx = bx0 + bx;
      if (!cc->origin[(size_t)aby * nbx + abx]) continue;
      int s = cc->strategy[(size_t)aby * nbx + abx];
      int bcx = cc->cov_x[s], bcy = cc->cov_y[s];
      int l2 = cc->log2cb[s];
      int cb = bcx * bcy;
      int size = cb * 64;
      int ord = cc->ord_lut[s];
      int quant = cc->qf[(size_t)aby * nbx + abx];
      int qfi = 0;
      while (qfi < nqf && quant > cc->qf_thr[qfi]) qfi++;
      int64_t base_px = (int64_t)aby * 8 * W + (int64_t)abx * 8;
      for (int ci = 0; ci < 3; ci++) {
        int c = kChanOrder[ci];
        int cidx = c < 2 ? (c ^ 1) : 2;
        int bc = cc->bctx_lut[((size_t)cidx * 13 + ord) * (nqf + 1) + qfi];
        const int32_t* oimg =
            cc->ord_img_flat + cc->ord_img_off[(size_t)s * 3 + c];
        int32_t* acc = cc->planes[c] + base_px;
        int32_t* nzm = nzmap + (size_t)c * bh * bw;
        int pred;
        if (bx == 0) {
          pred = by > 0 ? nzm[(size_t)(by - 1) * bw + bx] : 32;
        } else if (by == 0) {
          pred = nzm[(size_t)by * bw + bx - 1];
        } else {
          pred = (nzm[(size_t)(by - 1) * bw + bx] +
                  nzm[(size_t)by * bw + bx - 1] + 1) / 2;
        }
        if (pred > 64) pred = 64;
        int nz_bucket = pred < 8 ? pred : 4 + pred / 2;
        int nz_ctx = ctx_offset + nz_bucket * num_ctxs + bc;
        uint32_t nzeros =
            v_read_hybrid_uint_packed(&t, nz_ctx, &state, &br);
        if (nzeros > (uint32_t)(size - cb)) return 1;
        int nz_per_block = (int)((nzeros + cb - 1) >> l2);
        for (int yy = 0; yy < bcy; yy++)
          for (int xx = 0; xx < bcx; xx++)
            nzm[(size_t)(by + yy) * bw + bx + xx] = nz_per_block;
        int histo_offset = ctx_offset + num_ctxs * NONZERO_BUCKETS +
                           ZERO_DENSITY_CONTEXT_COUNT * bc;
        int prev = nzeros > (uint32_t)(size / 16) ? 0 : 1;
        int k = cb;
        int32_t remaining = (int32_t)nzeros;
        while (k < size && remaining != 0) {
          int nzl = (remaining + cb - 1) >> l2;
          int zctx = (kCoeffNumNonzeroContext[nzl] +
                      kCoeffFreqContext[k >> l2]) * 2 + prev;
          /* a lying nzeros (more remaining than positions left) pushes
           * the pair outside the 458-entry zero-density block; reject
           * instead of indexing past the context map */
          if (zctx >= ZERO_DENSITY_CONTEXT_COUNT) return 1;
          int ctx = histo_offset + zctx;
          uint32_t u = v_read_hybrid_uint_packed(&t, ctx, &state, &br);
          /* matches the Python path's bound; also keeps coeff << shift
           * inside int32 */
          if (u >= (1u << 27)) return 1;
          int32_t coeff =
              (u & 1) ? -(int32_t)((u + 1) >> 1) : (int32_t)(u >> 1);
          if (coeff >= 0) {
            acc[oimg[k]] += coeff << shift;
          } else {
            acc[oimg[k]] -= (-coeff) << shift;
          }
          prev = u ? 1 : 0;
          remaining -= prev;
          k++;
        }
        if (remaining != 0) return 1;
      }
    }
  }
  if (state != (0x13u << 16)) return 1;
  return 0;
}

static AliasEntryV* pack_alias_tables(
    const uint16_t* cutoff, const uint16_t* right, const uint16_t* freq0,
    const uint16_t* offsets1, const uint16_t* freq1, int log_alpha_size,
    int n_tables) {
  /* one cache line per (cluster, bucket); n_tables is the caller's true
   * table count — deriving it from a prefix of the context map missed
   * clusters referenced only by later histogram selectors */
  size_t tsize = (size_t)n_tables << log_alpha_size;
  AliasEntryV* entries = (AliasEntryV*)malloc(tsize * sizeof(AliasEntryV));
  if (!entries) return NULL;
  for (size_t j = 0; j < tsize; j++) {
    entries[j].cutoff = cutoff[j];
    entries[j].right = right[j];
    entries[j].freq0 = freq0[j];
    entries[j].offsets1 = offsets1[j];
    entries[j].freq1 = freq1[j];
  }
  return entries;
}

typedef struct {
  const AcImageCtx* cc;
  int tid, nthreads;
  int err;  /* 0 or 1000 + first bad group */
} AcWorker;

static void* ac_worker_run(void* arg) {
  AcWorker* w = (AcWorker*)arg;
  const AcImageCtx* cc = w->cc;
  int gdim = cc->group_dim_blocks;
  int32_t* nzmap =
      (int32_t*)malloc(sizeof(int32_t) * 3 * (size_t)gdim * gdim);
  if (!nzmap) {
    w->err = 9999;
    return NULL;
  }
  w->err = 0;
  for (int g = w->tid; g < cc->n_groups; g += w->nthreads) {
    if (decode_one_ac_group_img(cc, g, nzmap)) {
      w->err = 1000 + g;
      break;
    }
  }
  free(nzmap);
  return NULL;
}

/* Serial entry point (kept for single-group images and as the fallback
 * when thread creation fails). */
int decode_ac_image(
    const uint8_t* data, size_t data_size,
    const uint64_t* group_off, const uint64_t* group_size, int n_groups,
    int xsize_groups, int group_dim_blocks,
    const uint16_t* cutoff, const uint16_t* right, const uint16_t* freq0,
    const uint16_t* offsets1, const uint16_t* freq1, int log_alpha_size,
    const uint8_t* context_map,
    const uint32_t* cfg_split, const uint32_t* cfg_msb,
    const uint32_t* cfg_lsb,
    const int32_t* strategy, const uint8_t* origin, const int32_t* qf,
    int nby, int nbx,
    const int32_t* bctx_lut, const int64_t* qf_thr, int nqf,
    const int64_t* ord_img_off, const int32_t* ord_img_flat,
    const int32_t* cov_x, const int32_t* cov_y, const int32_t* log2cb,
    const int32_t* ord_lut,
    int histo_bits, int num_histograms, int n_tables,
    int num_ac_ctx, int num_ctxs, int shift,
    int W, int32_t* q0, int32_t* q1, int32_t* q2, int n_threads) {
  /* TOC offsets/sizes are attacker-controlled: every group's section
   * must lie inside the input buffer (the Python fallback slices
   * data[start:start+size]; mirror that bound here) */
  for (int g = 0; g < n_groups; g++) {
    if (group_off[g] > data_size ||
        group_size[g] > data_size - group_off[g]) {
      return 1000 + g;
    }
  }
  AliasEntryV* entries =
      pack_alias_tables(cutoff, right, freq0, offsets1, freq1,
                        log_alpha_size, n_tables);
  if (!entries) return 9999;
  AcImageCtx cc = {data, group_off, group_size, n_groups, xsize_groups,
                   group_dim_blocks, entries, log_alpha_size, context_map,
                   cfg_split, cfg_msb, cfg_lsb, strategy, origin, qf,
                   nby, nbx, bctx_lut, qf_thr, nqf, ord_img_off,
                   ord_img_flat, cov_x, cov_y, log2cb, ord_lut,
                   histo_bits, num_histograms, num_ac_ctx, num_ctxs,
                   shift, W, {q0, q1, q2}};
  int rc = 0;
  if (n_threads > n_groups) n_threads = n_groups;
  if (n_threads > 1) {
    /* per-AC-group data parallelism (dec_frame.cc:716 RunOnPool): the
     * groups' entropy streams and pixel ranges are independent */
    enum { kMaxThreads = 64 };
    if (n_threads > kMaxThreads) n_threads = kMaxThreads;
    pthread_t tids[kMaxThreads];
    AcWorker workers[kMaxThreads];
    int spawned = 0;
    for (int i = 0; i < n_threads; i++) {
      workers[i].cc = &cc;
      workers[i].tid = i;
      workers[i].nthreads = n_threads;
      workers[i].err = 0;
      if (i == 0) continue; /* thread 0 = calling thread */
      if (pthread_create(&tids[i], NULL, ac_worker_run, &workers[i])) {
        workers[i].err = -1; /* not spawned: rerun serially below */
        break;
      }
      spawned = i;
    }
    ac_worker_run(&workers[0]);
    for (int i = 1; i <= spawned; i++) pthread_join(tids[i], NULL);
    for (int i = 0; i <= spawned; i++) {
      if (workers[i].err > 0 && (rc == 0 || workers[i].err < rc))
        rc = workers[i].err;
    }
    if (spawned + 1 < n_threads && rc == 0) {
      /* threads that failed to spawn: decode their groups here */
      int32_t* nzmap = (int32_t*)malloc(
          sizeof(int32_t) * 3 * (size_t)group_dim_blocks * group_dim_blocks);
      if (!nzmap) rc = 9999;
      for (int i = spawned + 1; nzmap && i < n_threads; i++) {
        for (int g = i; g < n_groups && rc == 0; g += n_threads) {
          if (decode_one_ac_group_img(&cc, g, nzmap)) rc = 1000 + g;
        }
      }
      free(nzmap);
    }
  } else {
    int32_t* nzmap = (int32_t*)malloc(
        sizeof(int32_t) * 3 * (size_t)group_dim_blocks * group_dim_blocks);
    if (!nzmap) {
      free(entries);
      return 9999;
    }
    for (int g = 0; g < n_groups; g++) {
      if (decode_one_ac_group_img(&cc, g, nzmap)) {
        rc = 1000 + g;
        break;
      }
    }
    free(nzmap);
  }
  free(entries);
  return rc;
}

/* Decode all blocks of one AC group x pass.
 *
 * Per-block arrays (length n_blocks, raster order of origins):
 *   bx, by        block position inside the group
 *   cx, cy        covered blocks
 *   log2cb        log2(cx*cy)
 *   bsize         cx*cy*64
 *   bctx          int32[n_blocks*3], block context per channel (c-major:
 *                 bctx[i*3+c])
 *   order_off     int64[n_blocks*3], offset into orders_flat per channel
 *   out_off       int64[n_blocks], offset of channel 0 into out_flat;
 *                 channel c adds c*bsize[i]
 * nzeros_scratch: int32[3*bh*bw], zero-initialized by the caller.
 * out_flat: int32 coefficient storage (accumulated; caller zeroes on the
 * first pass).
 * Returns 0 ok, 1 invalid nzeros, 2 leftover nzeros.
 */
int decode_ac_group(
    const uint8_t* data, size_t data_size, uint64_t* bitpos_io,
    uint32_t* state_io,
    const uint16_t* cutoff, const uint16_t* right, const uint16_t* freq0,
    const uint16_t* offsets1, const uint16_t* freq1, int log_alpha_size,
    const uint8_t* context_map,
    const uint32_t* cfg_split, const uint32_t* cfg_msb,
    const uint32_t* cfg_lsb,
    int n_blocks, const int32_t* bx, const int32_t* by, const int32_t* cx,
    const int32_t* cy, const int32_t* log2cb, const int32_t* bsize,
    const int32_t* bctx, const int64_t* order_off,
    const int32_t* orders_flat, const int64_t* out_off,
    int bw, int bh, int ctx_offset, int shift, int num_ctxs,
    int32_t* nzeros_scratch, int32_t* out_flat) {
  BitReaderV br;
  br.data = data;
  br.size = data_size;
  uint64_t bitpos = *bitpos_io;
  br.pos = bitpos >> 3;
  br.buf = 0;
  br.bits = 0;
  {
    int rem = (int)(bitpos & 7);
    if (rem) vbr_read(&br, rem);
  }
  AnsTablesV t = {cutoff, right,   freq0,    offsets1, freq1,
                  log_alpha_size, context_map, cfg_split, cfg_msb, cfg_lsb};
  uint32_t state = *state_io;
  static const int kChanOrder[3] = {1, 0, 2};

  for (int i = 0; i < n_blocks; i++) {
    int bcx = cx[i], bcy = cy[i];
    int l2 = log2cb[i];
    int cb = bcx * bcy;
    int size = bsize[i];
    for (int ci = 0; ci < 3; ci++) {
      int c = kChanOrder[ci];
      const int32_t* order = orders_flat + order_off[(size_t)i * 3 + c];
      int32_t* acc = out_flat + out_off[i] + (int64_t)c * size;
      int32_t* nzmap = nzeros_scratch + (size_t)c * bh * bw;
      /* PredictFromTopAndLeft (entropy_coder.h:25-35) */
      int x = bx[i], y = by[i];
      int pred;
      if (x == 0) {
        pred = y > 0 ? nzmap[(size_t)(y - 1) * bw + x] : 32;
      } else if (y == 0) {
        pred = nzmap[(size_t)y * bw + x - 1];
      } else {
        pred = (nzmap[(size_t)(y - 1) * bw + x] +
                nzmap[(size_t)y * bw + x - 1] + 1) / 2;
      }
      int bc = bctx[(size_t)i * 3 + c];
      if (pred > 64) pred = 64;
      int nz_bucket = pred < 8 ? pred : 4 + pred / 2;
      int nz_ctx = ctx_offset + nz_bucket * num_ctxs + bc;
      uint32_t nzeros = v_read_hybrid_uint(&t, nz_ctx, &state, &br);
      if (nzeros > (uint32_t)(size - cb)) return 1;
      int nz_per_block = (int)((nzeros + cb - 1) >> l2);
      for (int yy = 0; yy < bcy; yy++)
        for (int xx = 0; xx < bcx; xx++)
          nzmap[(size_t)(y + yy) * bw + x + xx] = nz_per_block;
      int histo_offset =
          ctx_offset + num_ctxs * NONZERO_BUCKETS +
          ZERO_DENSITY_CONTEXT_COUNT * bc;
      int prev = nzeros > (uint32_t)(size / 16) ? 0 : 1;
      int k = cb;
      int32_t remaining = (int32_t)nzeros;
      while (k < size && remaining != 0) {
        int nzl = (remaining + cb - 1) >> l2;
        int zctx =
            (kCoeffNumNonzeroContext[nzl] + kCoeffFreqContext[k >> l2]) *
                2 +
            prev;
        if (zctx >= ZERO_DENSITY_CONTEXT_COUNT) return 1;
        int ctx = histo_offset + zctx;
        uint32_t u = v_read_hybrid_uint(&t, ctx, &state, &br);
        if (u >= (1u << 27)) return 1;
        int32_t coeff = (u & 1) ? -(int32_t)((u + 1) >> 1) : (int32_t)(u >> 1);
        if (coeff >= 0) {
          acc[order[k]] += coeff << shift;
        } else {
          acc[order[k]] -= (-coeff) << shift;
        }
        prev = u ? 1 : 0;
        remaining -= prev;
        k++;
      }
      if (remaining != 0) return 2;
    }
  }
  *state_io = state;
  *bitpos_io = ((uint64_t)br.pos << 3) - (uint64_t)br.bits;
  return 0;
}

/* ---- bulk auxiliary-stream readers (context maps, permutations) ----
 * These cover the host-side hot loops outside the AC image itself:
 * DecodeContextMap's per-entry reads and ReadPermutation's Lehmer
 * stream (coeff_order.cc:34-60, lehmer_code.h:61-99). Plain rANS only;
 * the Python caller falls back when LZ77/prefix is in play. */

static void vbr_init_at(BitReaderV* br, const uint8_t* data, size_t size,
                        uint64_t bitpos) {
  br->data = data;
  br->size = size;
  br->pos = bitpos >> 3;
  br->buf = 0;
  br->bits = 0;
  int rem = (int)(bitpos & 7);
  if (rem) (void)vbr_read(br, rem);
}

int ans_read_uints(const uint8_t* data, size_t size_bytes,
                   uint64_t* bitpos_io, uint32_t* state_io,
                   const uint16_t* cutoff, const uint16_t* right,
                   const uint16_t* freq0, const uint16_t* offsets1,
                   const uint16_t* freq1, int log_alpha_size,
                   const uint8_t* context_map, const uint32_t* cfg_split,
                   const uint32_t* cfg_msb, const uint32_t* cfg_lsb,
                   int n, int ctx, uint32_t* out) {
  BitReaderV br;
  vbr_init_at(&br, data, size_bytes, *bitpos_io);
  uint32_t state = *state_io;
  AnsTablesV t = {cutoff, right, freq0, offsets1, freq1, log_alpha_size,
                  context_map, cfg_split, cfg_msb, cfg_lsb};
  for (int i = 0; i < n; i++) {
    out[i] = v_read_hybrid_uint(&t, ctx, &state, &br);
  }
  *bitpos_io = ((uint64_t)br.pos << 3) - (uint64_t)br.bits;
  *state_io = state;
  return 0;
}

static int lehmer_decode_c(const uint32_t* code, uint32_t n, int32_t* out) {
  if (n == 0) return 0;
  int log2n = 0;
  if (n > 1) {
    log2n = 32 - __builtin_clz(n - 1);
    if (log2n < 1) log2n = 1;
  }
  uint32_t padded = 1u << log2n;
  uint32_t* temp = (uint32_t*)malloc((padded + 1) * sizeof(uint32_t));
  if (!temp) return -1;
  for (uint32_t i = 0; i < padded; i++) {
    uint32_t i1 = i + 1;
    temp[i] = i1 & (uint32_t)(-(int32_t)i1);
  }
  for (uint32_t i = 0; i < n; i++) {
    if (code[i] + i >= n) { free(temp); return 1; }
    uint32_t rank = code[i] + 1;
    uint32_t bit = padded, nxt = 0;
    for (int j = 0; j <= log2n; j++) {
      uint32_t cand = nxt + bit;
      bit >>= 1;
      if (temp[cand - 1] < rank) {
        nxt = cand;
        rank -= temp[cand - 1];
      }
    }
    out[i] = (int32_t)nxt;
    nxt += 1;
    while (nxt <= padded) {
      temp[nxt - 1] -= 1;
      nxt += nxt & (uint32_t)(-(int32_t)nxt);
    }
  }
  free(temp);
  return 0;
}

int ans_read_permutation(const uint8_t* data, size_t size_bytes,
                         uint64_t* bitpos_io, uint32_t* state_io,
                         const uint16_t* cutoff, const uint16_t* right,
                         const uint16_t* freq0, const uint16_t* offsets1,
                         const uint16_t* freq1, int log_alpha_size,
                         const uint8_t* context_map,
                         const uint32_t* cfg_split, const uint32_t* cfg_msb,
                         const uint32_t* cfg_lsb,
                         uint32_t skip, uint32_t size, int32_t* out_perm) {
  BitReaderV br;
  vbr_init_at(&br, data, size_bytes, *bitpos_io);
  uint32_t state = *state_io;
  AnsTablesV t = {cutoff, right, freq0, offsets1, freq1, log_alpha_size,
                  context_map, cfg_split, cfg_msb, cfg_lsb};
  int size_ctx = size ? 32 - __builtin_clz(size) : 0;
  if (size_ctx > 7) size_ctx = 7;
  uint32_t end =
      v_read_hybrid_uint(&t, size_ctx, &state, &br) + skip;
  if (end > size) return 2;
  uint32_t* lehmer = (uint32_t*)calloc(size, sizeof(uint32_t));
  if (!lehmer) return -1;
  uint32_t last = 0;
  for (uint32_t i = skip; i < end; i++) {
    int ctx = last ? 32 - __builtin_clz(last) : 0;
    if (ctx > 7) ctx = 7;
    lehmer[i] = v_read_hybrid_uint(&t, ctx, &state, &br);
    last = lehmer[i];
    if (lehmer[i] >= size - i) { free(lehmer); return 3; }
  }
  int rc = lehmer_decode_c(lehmer, size, out_perm);
  free(lehmer);
  if (rc) return rc < 0 ? -1 : 4;
  *bitpos_io = ((uint64_t)br.pos << 3) - (uint64_t)br.bits;
  *state_io = state;
  return 0;
}

/* InverseMoveToFrontTransform (dec_context_map.cc:22-34). values are
 * indices < 256; transformed in place. */
int inverse_mtf(uint32_t* values, int n) {
  uint8_t mtf[256];
  for (int i = 0; i < 256; i++) mtf[i] = (uint8_t)i;
  for (int i = 0; i < n; i++) {
    uint32_t idx = values[i];
    if (idx >= 256) return 1;
    uint8_t val = mtf[idx];
    values[i] = val;
    memmove(mtf + 1, mtf, idx);
    mtf[0] = val;
  }
  return 0;
}
