"""Butteraugli comparator on device (JAX port of butteraugli.py).

Same model as the host comparator (butteraugli/butteraugli.cc): opsin
dynamics, LF/MF/HF/UHF separation, 16-direction Malta filters, psycho
masking and the half-res pass — expressed as one jit-able program so
the effort>=7 quant-refinement loop's perceptual evaluation runs on the
device instead of host NumPy. Constants and Malta tap patterns are
shared with the host module (they ARE the model).

All control flow is static (sigmas, tap patterns, image shape), so the
whole diffmap compiles to a single XLA program; the separable blurs
are dense banded matrix products in full float32 (Precision.HIGHEST).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from .butteraugli import (  # constants = the model
    MALTA_FULL,
    MALTA_LF,
    NORM1_HF,
    NORM1_HF_X,
    NORM1_MF,
    NORM1_MF_X,
    NORM1_UHF,
    NORM1_UHF_X,
    W_HF_MALTA,
    W_HF_MALTA_X,
    W_MF_MALTA,
    W_MF_MALTA_X,
    W_UHF_MALTA,
    W_UHF_MALTA_X,
    WMUL,
    _GLOBAL_SCALE,
    _gauss_kernel,
)


@functools.lru_cache(maxsize=None)
def _blur_matrix(n: int, sigma: float):
    """Row-normalized banded Gaussian as a dense (n, n) matrix: the
    separable blur becomes TWO MATMULS (B_y @ img @ B_x^T) with a tiny
    compiled program, instead of a 33-tap unrolled shift chain. Row
    normalization reproduces the host blur's border renormalization
    exactly."""
    k = _gauss_kernel(sigma)
    r = len(k) // 2
    B = np.zeros((n, n), dtype=np.float64)
    for j, wj in enumerate(k):
        d = j - r
        idx = np.arange(max(0, -d), min(n, n - d))
        B[idx, idx + d] += wj
    B /= B.sum(axis=1, keepdims=True)
    return B.astype(np.float32)


def _blur(img, sigma):
    """Separable truncated-Gaussian blur with border renormalization."""
    h, w = img.shape
    by = jnp.asarray(_blur_matrix(h, sigma))
    bx = jnp.asarray(_blur_matrix(w, sigma))
    return jnp.einsum("ij,jk,lk->il", by, img, bx,
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)


def _opsin_absorbance(r, g, b, clamp):
    m = (0.29956550340058319, 0.63373087833825936, 0.077705617820981968,
         1.7557483643287353, 0.22158691104574774, 0.69391388044116142,
         0.0987313588422, 1.7557483643287353, 0.02, 0.02,
         0.20480129041026129, 12.226454707163354)
    o0 = m[0] * r + m[1] * g + m[2] * b + m[3]
    o1 = m[4] * r + m[5] * g + m[6] * b + m[7]
    o2 = m[8] * r + m[9] * g + m[10] * b + m[11]
    if clamp:
        o0 = jnp.maximum(o0, m[3])
        o1 = jnp.maximum(o1, m[7])
        o2 = jnp.maximum(o2, m[11])
    return o0, o1, o2


def _gamma(v):
    return 19.245013259874995 * jnp.log(jnp.maximum(v, 0.0)
                                        + 9.9710635769299145) \
        - 23.16046239805755


def opsin_dynamics_image(rgb_linear, intensity_target=80.0):
    rgb = rgb_linear * intensity_target
    blurred = [_blur(rgb[c], 1.2) for c in range(3)]
    pre = _opsin_absorbance(blurred[0], blurred[1], blurred[2], clamp=True)
    sens = []
    for p in pre:
        p = jnp.maximum(p, 1e-4)
        sens.append(jnp.maximum(_gamma(p) / p, 1e-4))
    cur = _opsin_absorbance(rgb[0], rgb[1], rgb[2], clamp=False)
    m0 = jnp.maximum(cur[0] * sens[0], 1.7557483643287353)
    m1 = jnp.maximum(cur[1] * sens[1], 1.7557483643287353)
    m2 = jnp.maximum(cur[2] * sens[2], 12.226454707163354)
    return jnp.stack([m0 - m1, m0 + m1, m2])


def _remove_range(x, w):
    return jnp.where(x > w, x - w, jnp.where(x < -w, x + w, 0.0))


def _amplify_range(x, w):
    return jnp.where(x > w, x + w, jnp.where(x < -w, x - w, 2.0 * x))


def _maximum_clamp(v, maxval):
    mul = 0.724216145665
    return jnp.where(v >= maxval, (v - maxval) * mul + maxval,
                     jnp.where(v < -maxval, (v + maxval) * mul - maxval,
                               v))


def separate_frequencies(xyb):
    sigma_lf, sigma_hf, sigma_uhf = 7.15593339443, 3.22489901262, \
        1.56416327805
    lf_b = [_blur(xyb[c], sigma_lf) for c in range(3)]
    mf = [xyb[c] - lf_b[c] for c in range(3)]
    lx, ly, lb = lf_b[0], lf_b[1], lf_b[2]
    lf = jnp.stack([lx * 33.832837186260, ly * 14.458268100570,
                    (lb - 0.362267051518 * ly) * 49.87984651440])
    hf = [None, None]
    for c in range(3):
        if c == 2:
            mf[2] = _blur(mf[2], sigma_hf)
            break
        blurred = _blur(mf[c], sigma_hf)
        hf[c] = mf[c] - blurred
        mf[c] = _remove_range(blurred, 0.29) if c == 0 \
            else _amplify_range(blurred, 0.1)
    s = 0.653020556257
    scaler = s + (1.0 - s) * (46.0 / (hf[1] * hf[1] + 46.0))
    hf[0] = hf[0] * scaler
    uhf = [None, None]
    for c in range(2):
        blurred = _blur(hf[c], sigma_uhf)
        uhf[c] = hf[c] - blurred
        if c == 0:
            hf[0] = _remove_range(blurred, 1.5)
            uhf[0] = _remove_range(uhf[0], 0.04)
        else:
            h = _maximum_clamp(blurred, 28.4691806922)
            uhf[1] = _maximum_clamp(uhf[1], 5.19175294647) * 2.69313763794
            hf[1] = _amplify_range(h * 2.155, 0.132)
    return lf, jnp.stack(mf), hf, uhf


def _malta_diffs(v0, v1, w_0gt1, w_0lt1, norm1, mulli):
    len_ = 3.75
    w_pre0gt1 = mulli * np.sqrt(0.5 * w_0gt1) / (len_ * 2 + 1)
    w_pre0lt1 = mulli * np.sqrt(0.33 * w_0lt1) / (len_ * 2 + 1)
    norm2_0gt1 = w_pre0gt1 * norm1
    norm2_0lt1 = w_pre0lt1 * norm1
    absval = 0.5 * (jnp.abs(v0) + jnp.abs(v1))
    diff = v0 - v1
    scaler = norm2_0gt1 / (norm1 + absval)
    diffs = scaler * diff
    scaler2 = norm2_0lt1 / (norm1 + absval)
    fabs0 = jnp.abs(v0)
    too_small = 0.55 * fabs0
    too_big = 1.05 * fabs0
    neg = v0 < 0
    impact_neg = jnp.where(
        v1 > -too_small, scaler2 * (v1 + too_small),
        jnp.where(v1 < -too_big, -(scaler2 * (-v1 - too_big)), 0.0))
    impact_pos = jnp.where(
        v1 < too_small, scaler2 * (too_small - v1),
        jnp.where(v1 > too_big, -(scaler2 * (v1 - too_big)), 0.0))
    return diffs + jnp.where(neg, -impact_neg, impact_pos)


def _malta_filter(diffs, patterns):
    h, w = diffs.shape
    p = jnp.pad(diffs, 4)
    out = None
    for taps in patterns:
        acc = None
        for (dy, dx) in taps:
            t = jax.lax.slice(p, (4 + dy, 4 + dx), (4 + dy + h, 4 + dx + w))
            acc = t if acc is None else acc + t
        sq = acc * acc
        out = sq if out is None else out + sq
    return out


def _malta_diff_map(v0, v1, w_0gt1, w_0lt1, norm1, lf):
    mulli = 0.611612573796 if lf else 0.39905817637
    diffs = _malta_diffs(v0, v1, w_0gt1, w_0lt1, norm1, mulli)
    return _malta_filter(diffs, MALTA_LF if lf else MALTA_FULL)


def _fuzzy_erosion(src):
    h, w = src.shape
    big = jnp.float32(np.inf)
    planes = [src]
    for dy in (-3, 0, 3):
        for dx in (-3, 0, 3):
            if dy == 0 and dx == 0:
                continue
            sh = jnp.full((h, w), big)
            y0, y1 = max(0, -dy), min(h, h - dy)
            x0, x1 = max(0, -dx), min(w, w - dx)
            sh = sh.at[y0:y1, x0:x1].set(src[y0 + dy:y1 + dy,
                                             x0 + dx:x1 + dx])
            planes.append(sh)
    stack = jnp.stack(planes)
    part = jnp.sort(stack, axis=0)
    m0 = part[0]
    m1 = jnp.minimum(part[1], 2 * m0)
    m2 = jnp.minimum(part[2], 2 * m0)
    return 0.45 * m0 + 0.3 * m1 + 0.25 * m2


def _mask_psycho(hf0, uhf0, hf1, uhf1, block_diff_ac_y):
    def combine(hf, uhf):
        xdiff = (uhf[0] + hf[0]) * 2.5
        ydiff = uhf[1] * 0.4 + hf[1] * 0.4
        return jnp.sqrt(xdiff * xdiff + ydiff * ydiff)

    def precompute(m):
        mul, bias = 6.19424080439, 12.61050594197
        b = mul * bias
        return jnp.sqrt(mul * jnp.abs(m) + b) - np.sqrt(b)

    mask0 = combine(hf0, uhf0)
    mask1 = combine(hf1, uhf1)
    blurred0 = _blur(precompute(mask0), 2.7)
    blurred1 = _blur(precompute(mask1), 2.7)
    block_diff_ac_y = block_diff_ac_y + 10.0 * (blurred0 - blurred1) ** 2
    return _fuzzy_erosion(blurred0), block_diff_ac_y


def _mask_y(delta):
    c = 2.5485944793 / (0.451936922203 * delta + 0.829591754942)
    r = _GLOBAL_SCALE * (1.0 + c)
    return r * r


def _mask_dc_y(delta):
    c = 0.505054525019 / (3.87449418804 * delta + 0.20025578522)
    r = _GLOBAL_SCALE * (1.0 + c)
    return r * r


def _diffmap_full(xyb0, xyb1, hf_asymmetry, xmul):
    lf0, mf0, hf0, uhf0 = separate_frequencies(xyb0)
    lf1, mf1, hf1, uhf1 = separate_frequencies(xyb1)
    sq = np.sqrt(hf_asymmetry)
    ac = [None, None, None]
    ac[1] = _malta_diff_map(uhf0[1], uhf1[1], W_UHF_MALTA * hf_asymmetry,
                            W_UHF_MALTA / hf_asymmetry, NORM1_UHF,
                            lf=False)
    ac[0] = _malta_diff_map(uhf0[0], uhf1[0], W_UHF_MALTA_X * hf_asymmetry,
                            W_UHF_MALTA_X / hf_asymmetry, NORM1_UHF_X,
                            lf=False)
    ac[1] = ac[1] + _malta_diff_map(hf0[1], hf1[1], W_HF_MALTA * sq,
                                    W_HF_MALTA / sq, NORM1_HF, lf=True)
    ac[0] = ac[0] + _malta_diff_map(hf0[0], hf1[0], W_HF_MALTA_X * sq,
                                    W_HF_MALTA_X / sq, NORM1_HF_X,
                                    lf=True)
    ac[1] = ac[1] + _malta_diff_map(mf0[1], mf1[1], W_MF_MALTA, W_MF_MALTA,
                                    NORM1_MF, lf=True)
    ac[0] = ac[0] + _malta_diff_map(mf0[0], mf1[0], W_MF_MALTA_X,
                                    W_MF_MALTA_X, NORM1_MF_X, lf=True)
    ac[2] = jnp.zeros_like(ac[0])
    dc = [None, None, None]
    for c in range(3):
        if c < 2:
            d = hf0[c] - hf1[c]
            total = d * d * (WMUL[c] * hf_asymmetry * 0.8)
            fabs0 = jnp.abs(hf0[c])
            too_small = 0.4 * fabs0
            too_big = fabs0
            v = jnp.where(
                hf0[c] < 0,
                jnp.where(hf1[c] > -too_small, hf1[c] + too_small,
                          jnp.where(hf1[c] < -too_big, -hf1[c] - too_big,
                                    0.0)),
                jnp.where(hf1[c] < too_small, too_small - hf1[c],
                          jnp.where(hf1[c] > too_big, hf1[c] - too_big,
                                    0.0)))
            ac[c] = ac[c] + total + (WMUL[c] / hf_asymmetry * 0.8) * v * v
        ac[c] = ac[c] + WMUL[3 + c] * (mf0[c] - mf1[c]) ** 2
        dc[c] = WMUL[6 + c] * (lf0[c] - lf1[c]) ** 2
    mask, ac1 = _mask_psycho(hf0, uhf0, hf1, uhf1, ac[1])
    ac[1] = ac1
    my = _mask_y(mask)
    mdc = _mask_dc_y(mask)
    dsum = (dc[0] * xmul + dc[1] + dc[2]) * mdc
    asum = (ac[0] * xmul + ac[1] + ac[2]) * my
    return jnp.sqrt(jnp.maximum(dsum + asum, 0.0))


def _subsample2x(rgb):
    c, h, w = rgb.shape
    hh, ww = (h + 1) // 2, (w + 1) // 2
    idx_y = np.minimum(np.arange(hh * 2), h - 1)
    idx_x = np.minimum(np.arange(ww * 2), w - 1)
    ext = rgb[:, idx_y][:, :, idx_x]
    return 0.25 * (ext[:, 0::2, 0::2] + ext[:, 1::2, 0::2]
                   + ext[:, 0::2, 1::2] + ext[:, 1::2, 1::2])


@functools.partial(jax.jit,
                   static_argnames=("hf_asymmetry", "xmul",
                                    "intensity_target"))
def butteraugli_diffmap_jax(rgb0_linear, rgb1_linear, hf_asymmetry=0.8,
                            xmul=1.0, intensity_target=80.0):
    """Per-pixel diffmap of two linear RGB (3, H, W) images in [0, 1],
    as one jitted device program (incl. the half-res pass)."""
    rgb0 = rgb0_linear.astype(jnp.float32)
    rgb1 = rgb1_linear.astype(jnp.float32)
    h, w = rgb0.shape[1:]
    xyb0 = opsin_dynamics_image(rgb0, intensity_target)
    xyb1 = opsin_dynamics_image(rgb1, intensity_target)
    diffmap = _diffmap_full(xyb0, xyb1, hf_asymmetry, xmul)
    if min(h, w) >= 16:
        s0 = opsin_dynamics_image(_subsample2x(rgb0), intensity_target)
        s1 = opsin_dynamics_image(_subsample2x(rgb1), intensity_target)
        sub = _diffmap_full(s0, s1, hf_asymmetry, xmul)
        up = jnp.repeat(jnp.repeat(sub, 2, 0), 2, 1)[:h, :w]
        diffmap = diffmap * (1.0 - 0.3 * 0.5) + 0.5 * up
    return diffmap


def butteraugli_score_jax(rgb0_linear, rgb1_linear, hf_asymmetry=0.8,
                          intensity_target=80.0) -> float:
    """Butteraugli distance (max of the device diffmap)."""
    if min(rgb0_linear.shape[1:]) < 8:
        return 0.0
    dm = butteraugli_diffmap_jax(np.asarray(rgb0_linear),
                                 np.asarray(rgb1_linear),
                                 hf_asymmetry=hf_asymmetry,
                                 intensity_target=intensity_target)
    return float(jnp.max(dm))
