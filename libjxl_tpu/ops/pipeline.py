"""Device compute pipelines for the VarDCT hot paths (JAX/XLA).

This is where the reference's per-block Highway SIMD loops
(dec_group.cc DequantBlock/TransformToPixels, enc_group.cc
ComputeCoefficients) become batched matrix products: every 8x8 block
in the image is one row of a big einsum against the DCT basis, and the
element-wise dequant/CfL/XYB stages fuse around it.

Layouts:
  blocks:   f32[3, nby, nbx, 8, 8]   per-block coefficients/pixels
  image:    f32[3, H, W]             planar XYB or RGB
All functions are jit-friendly (static shapes, no Python control flow on
traced values).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..io.headers import (
    DEFAULT_INVERSE_OPSIN_MATRIX,
    DEFAULT_QUANT_BIAS,
    OPSIN_ABSORBANCE_BIAS,
    OPSIN_ABSORBANCE_MATRIX,
)
from .dct import fwd_matrix, inv_matrix

COLOR_TILE_BLOCKS = 8


def blocks_to_image(blocks):
    """f32[c, nby, nbx, 8, 8] -> f32[c, nby*8, nbx*8]."""
    c, nby, nbx, _, _ = blocks.shape
    return blocks.transpose(0, 1, 3, 2, 4).reshape(c, nby * 8, nbx * 8)


def image_to_blocks(image):
    c, h, w = image.shape
    nby, nbx = h // 8, w // 8
    return image.reshape(c, nby, 8, nbx, 8).transpose(0, 1, 3, 2, 4)


@functools.lru_cache(maxsize=None)
def _consts():
    # NumPy (not jnp) so cached values can never be traced-and-leaked
    # across jit/shard_map scopes.
    return {
        "fwd8": fwd_matrix(8).astype(np.float32),
        "inv8": inv_matrix(8).astype(np.float32),
        "opsin": np.asarray(OPSIN_ABSORBANCE_MATRIX, dtype=np.float32),
        "opsin_inv": np.asarray(DEFAULT_INVERSE_OPSIN_MATRIX,
                                dtype=np.float32),
        "bias": np.float32(OPSIN_ABSORBANCE_BIAS),
        "cbrt_bias": np.float32(OPSIN_ABSORBANCE_BIAS ** (1 / 3)),
        "qbias": np.asarray(DEFAULT_QUANT_BIAS, dtype=np.float32),
    }


def idct8_blocks(blocks):
    """Batched 8x8 IDCT: one 8x8 matmul pair per block.

    Blocks are in the bitstream's transposed layout ([hfreq][vfreq],
    ComputeScaledDCT square convention) — the einsum untransposes for free.
    Precision HIGHEST keeps the products in full float32 (no TF32 or
    bf16 passes): the conformance error bounds (ISO 18181-3) do not
    survive reduced-precision products."""
    k = _consts()
    return jnp.einsum("ru,...vu,cv->...rc", k["inv8"], blocks, k["inv8"],
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)


def dct8_blocks(blocks):
    """Inverse of idct8_blocks: pixels -> transposed-layout coefficients."""
    k = _consts()
    return jnp.einsum("ur,...rc,vc->...vu", k["fwd8"], blocks, k["fwd8"],
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)


def adjust_quant_bias_jax(q, c):
    k = _consts()
    qb = k["qbias"]
    qf = q.astype(jnp.float32)
    safe = jnp.where(qf == 0, 1.0, qf)
    general = qf - qb[3] / safe
    return jnp.where(qf == 0, 0.0,
                     jnp.where(qf == 1, qb[c],
                               jnp.where(qf == -1, -qb[c], general)))


def xyb_to_rgb_jax(xyb):
    k = _consts()
    gr = xyb[1] + xyb[0] + k["cbrt_bias"]
    gg = xyb[1] - xyb[0] + k["cbrt_bias"]
    gb = xyb[2] + k["cbrt_bias"]
    mixed = jnp.stack([gr * gr * gr - k["bias"], gg * gg * gg - k["bias"],
                       gb * gb * gb - k["bias"]])
    return jnp.einsum("ij,jhw->ihw", k["opsin_inv"], mixed,
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)


def rgb_to_xyb_jax(rgb):
    k = _consts()
    mixed = jnp.einsum("ij,jhw->ihw", k["opsin"], rgb,
                       precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32) + k["bias"]
    mixed = jnp.maximum(mixed, 0.0)
    cbrt = jnp.cbrt(mixed) - k["cbrt_bias"]
    return jnp.stack([0.5 * (cbrt[0] - cbrt[1]),
                      0.5 * (cbrt[0] + cbrt[1]), cbrt[2]])


def _tile_to_blocks(tile_map, nby, nbx):
    """Expand a per-64px-tile map to per-block values."""
    t = jnp.repeat(jnp.repeat(tile_map, COLOR_TILE_BLOCKS, axis=0),
                   COLOR_TILE_BLOCKS, axis=1)
    return t[:nby, :nbx]


def decode_pixels(qcoeffs, qf, dc, ytox_map, ytob_map, dm, inv_global_scale,
                  x_dm_mult, b_dm_mult, color_factor=84.0, base_x=0.0,
                  base_b=1.0):
    """VarDCT decode compute path (DCT8 layout), fully batched.

    qcoeffs: i32[3, nby, nbx, 8, 8]; qf: i32[nby, nbx];
    dc: f32[3, nby, nbx] (already dequantized);
    ytox/ytob_map: i32 per-tile CfL multipliers; dm: f32[3, 8, 8].
    Returns linear RGB f32[3, nby*8, nbx*8].

    Mirrors DequantBlock (dec_group.cc:96-165) + TransformToPixels + XYB.
    """
    nby, nbx = qf.shape
    scaled = (inv_global_scale / qf.astype(jnp.float32))[None, :, :, None, None]
    x_cc = (base_x + _tile_to_blocks(ytox_map, nby, nbx).astype(jnp.float32)
            / color_factor)[:, :, None, None]
    b_cc = (base_b + _tile_to_blocks(ytob_map, nby, nbx).astype(jnp.float32)
            / color_factor)[:, :, None, None]
    dq_y = adjust_quant_bias_jax(qcoeffs[1], 1) * dm[1] * scaled[0]
    dq_x = adjust_quant_bias_jax(qcoeffs[0], 0) * dm[0] * scaled[0] * x_dm_mult \
        + x_cc * dq_y
    dq_b = adjust_quant_bias_jax(qcoeffs[2], 2) * dm[2] * scaled[0] * b_dm_mult \
        + b_cc * dq_y
    coeffs = jnp.stack([dq_x, dq_y, dq_b])
    coeffs = coeffs.at[:, :, :, 0, 0].set(dc)
    pixels = idct8_blocks(coeffs)
    xyb = blocks_to_image(pixels)
    return xyb_to_rgb_jax(xyb)


def decode_xyb(qcoeffs, qf, dc, ytox_map, ytob_map, dm, inv_global_scale,
               x_dm_mult, b_dm_mult, color_factor=84.0, base_x=0.0,
               base_b=1.0):
    """decode_pixels without the final XYB->RGB stage: returns the XYB
    image f32[3, nby*8, nbx*8] for render-pipeline post-stages
    (gaborish/EPF run on XYB)."""
    nby, nbx = qf.shape
    scaled = (inv_global_scale / qf.astype(jnp.float32))[None, :, :, None,
                                                         None]
    x_cc = (base_x + _tile_to_blocks(ytox_map, nby, nbx).astype(jnp.float32)
            / color_factor)[:, :, None, None]
    b_cc = (base_b + _tile_to_blocks(ytob_map, nby, nbx).astype(jnp.float32)
            / color_factor)[:, :, None, None]
    dq_y = adjust_quant_bias_jax(qcoeffs[1], 1) * dm[1] * scaled[0]
    dq_x = adjust_quant_bias_jax(qcoeffs[0], 0) * dm[0] * scaled[0] \
        * x_dm_mult + x_cc * dq_y
    dq_b = adjust_quant_bias_jax(qcoeffs[2], 2) * dm[2] * scaled[0] \
        * b_dm_mult + b_cc * dq_y
    coeffs = jnp.stack([dq_x, dq_y, dq_b])
    coeffs = coeffs.at[:, :, :, 0, 0].set(dc)
    pixels = idct8_blocks(coeffs)
    return blocks_to_image(pixels)


def _row_transform8(img, m):
    """Apply an 8x8 matrix within each 8-row band along H:
    out[c, 8b+r, x] = sum_u m[r, u] * img[c, 8b+u, x].

    Keeps W (>= 2048 typical) as the minor dim."""
    c, h, w = img.shape
    t = img.reshape(c, h // 8, 8, w)
    out = jnp.einsum("ru,cnuw->cnrw", m, t,
                     precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32)
    return out.reshape(c, h, w)


def idct8_image(coeffs):
    """8x8 IDCT on image-layout coefficients (3, H, W) stored in the
    bitstream's per-block transposed layout: the two row transforms are
    chained without the final global transpose-back, which exactly undoes
    the per-block transpose while keeping every tensor in a wide layout."""
    k = _consts()
    c, h, w = coeffs.shape
    blocks = coeffs.reshape(c, h // 8, 8, w // 8, 8).transpose(0, 1, 3, 2, 4)
    out = idct8_blocks(blocks)
    return out.transpose(0, 1, 3, 2, 4).reshape(c, h, w)


def dct8_image(pixels):
    k = _consts()
    c, h, w = pixels.shape
    blocks = pixels.reshape(c, h // 8, 8, w // 8, 8).transpose(0, 1, 3, 2, 4)
    out = dct8_blocks(blocks)
    return out.transpose(0, 1, 3, 2, 4).reshape(c, h, w)


def _block_to_px(block_map, h, w):
    """(nby, nbx) per-block values -> (H, W) per-pixel."""
    return jnp.repeat(jnp.repeat(block_map, 8, axis=0), 8, axis=1)[:h, :w]


def decode_xyb_image(qimg, qf, dc, ytox_map, ytob_map, dm,
                     inv_global_scale, x_dm_mult, b_dm_mult,
                     color_factor=84.0, base_x=0.0, base_b=1.0):
    """Image-layout decode compute path: qimg i32[3, H, W] holds each
    block's coefficients as an 8x8 tile (same bytes as the bitstream's
    blocks, laid out in place). Numerically identical to decode_xyb; the
    wide layout needs no per-block reshapes between stages."""
    _, h, w = qimg.shape
    nby, nbx = h // 8, w // 8
    # fused per-position multiplier: dm[c, y%8, x%8] * scaled[y//8, x//8]
    # as one block-broadcast product (one materialization instead of a
    # tiled dm image plus an upsampled scale image)
    scaled_b = inv_global_scale / qf.astype(jnp.float32)
    mult = (dm[:, None, :, None, :]
            * scaled_b[None, :, None, :, None]).reshape(3, h, w)
    tile_px = 8 * COLOR_TILE_BLOCKS
    x_cc = base_x + jnp.repeat(jnp.repeat(
        ytox_map.astype(jnp.float32), tile_px, 0), tile_px, 1)[:h, :w] \
        / color_factor
    b_cc = base_b + jnp.repeat(jnp.repeat(
        ytob_map.astype(jnp.float32), tile_px, 0), tile_px, 1)[:h, :w] \
        / color_factor
    dq_y = adjust_quant_bias_jax(qimg[1], 1) * mult[1]
    dq_x = adjust_quant_bias_jax(qimg[0], 0) * mult[0] \
        * x_dm_mult + x_cc * dq_y
    dq_b = adjust_quant_bias_jax(qimg[2], 2) * mult[2] \
        * b_dm_mult + b_cc * dq_y
    coeffs = jnp.stack([dq_x, dq_y, dq_b])
    # insert DC at block origins via an elementwise mask-select, which
    # fuses with the dequant chain (a stride-8 scatter would not)
    dc_mask = ((jnp.arange(h) % 8 == 0)[:, None]
               & (jnp.arange(w) % 8 == 0)[None, :])
    dc_up = jnp.repeat(jnp.repeat(dc, 8, 1), 8, 2)
    coeffs = jnp.where(dc_mask[None], dc_up, coeffs)
    return idct8_image(coeffs)


@functools.lru_cache(maxsize=None)
def special_matrix(strategy: int) -> np.ndarray:
    """(64, 64) f32: pixels_flat = M @ coeffs_flat for an 8x8-tile
    strategy (IDENTITY/DCT2X2/DCT4X4/DCT8X4/DCT4X8/AFV0-3 and DCT8).
    Every TransformToPixels case is linear, so the whole per-strategy
    special-case code collapses to one matmul on device."""
    from ..vardct.transforms import transform_to_pixels

    m = np.zeros((64, 64), dtype=np.float64)
    for k in range(64):
        e = np.zeros(64)
        e[k] = 1.0
        m[:, k] = transform_to_pixels(strategy, e.reshape(8, 8)).reshape(64)
    return m.astype(np.float32)


def decode_special_tiles(q, dc, scaled, x_cc, b_cc, dm_kind, mat,
                         x_dm_mult, b_dm_mult):
    """Batched dequant + CfL + inverse transform for one 8x8-tile
    strategy. q: i32[n, 3, 64]; dc: f32[n, 3]; scaled/x_cc/b_cc: f32[n];
    dm_kind: f32[3, 64]; mat: f32[64, 64]. Returns f32[n, 3, 8, 8]."""
    s = scaled[:, None]
    dq_y = adjust_quant_bias_jax(q[:, 1], 1) * dm_kind[1] * s
    dq_x = adjust_quant_bias_jax(q[:, 0], 0) * dm_kind[0] * s * x_dm_mult \
        + x_cc[:, None] * dq_y
    dq_b = adjust_quant_bias_jax(q[:, 2], 2) * dm_kind[2] * s * b_dm_mult \
        + b_cc[:, None] * dq_y
    co = jnp.stack([dq_x, dq_y, dq_b], axis=1)
    co = co.at[:, :, 0].set(dc)
    pix = jnp.einsum("ncs,ps->ncp", co, mat,
                     precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32)
    return pix.reshape(-1, 3, 8, 8)


def decode_big_tiles(q, dc_tiles, scaled, x_cc, b_cc, dm_kind,
                     x_dm_mult, b_dm_mult, rows, cols, llf_sy, llf_sx):
    """Batched dequant + LLF-from-DC + IDCT for one plain-DCT size
    > 8x8 (jnp port of vardct.frame._render_dct_batch).

    q: i32[n, 3, wr, wc] wide layout; dc_tiles: f32[n, 3, cy, cx];
    dm_kind: f32[3, wr, wc]; llf_sy/llf_sx: f32 resample scales.
    Returns f32[n, 3, rows, cols] pixel tiles."""
    from .dct import make_jax_dct

    jdct2d, jidct2d = make_jax_dct()
    s = scaled[:, None, None]
    dq_y = adjust_quant_bias_jax(q[:, 1], 1) * dm_kind[1] * s
    dq_x = adjust_quant_bias_jax(q[:, 0], 0) * dm_kind[0] * s * x_dm_mult \
        + x_cc[:, None, None] * dq_y
    dq_b = adjust_quant_bias_jax(q[:, 2], 2) * dm_kind[2] * s * b_dm_mult \
        + b_cc[:, None, None] * dq_y
    co = jnp.stack([dq_x, dq_y, dq_b], axis=1)
    cy, cx = dc_tiles.shape[-2:]
    llf = jdct2d(dc_tiles, cy, cx)
    lh, lw = min(cy, cx), max(cy, cx)
    llf = llf / (llf_sy[:, None] * llf_sx[None, :])
    co = co.at[:, :, :lh, :lw].set(llf)
    return jidct2d(co, rows, cols)


def decode_size_pass(qimg, qf_px, dc, ytox_px, ytob_px, dm_tile,
                     x_dm_mult, b_dm_mult, rows, cols, llf_sy, llf_sx,
                     llf_mask_tile):
    """Dense full-grid dequant + LLF + IDCT for one plain-DCT tile size
    (rows, cols), 16x16 .. 64x64. No gathers or scatters: every aligned
    tile of the grid is transformed and the caller mask-selects the
    pixels whose covering block really uses this size — trading a few
    extra matmul passes for an XLA-fusable dense pipeline (a dense
    reformulation of dec_group.cc's per-block loop).

    qf_px/ytox_px/ytob_px: per-pixel f32 maps (constant within a tile by
    construction); dm_tile: f32[3, rows, cols] dequant weights laid out
    in tile order; llf_mask_tile: bool[rows, cols] True at LLF slots.
    """
    from .dct import make_jax_dct

    jdct2d, jidct2d = make_jax_dct()
    _, h, w = qimg.shape
    nty, ntx = h // rows, w // cols
    cy, cx = rows // 8, cols // 8
    wr, wc = min(rows, cols), max(rows, cols)
    dmt = jnp.tile(dm_tile, (1, nty, ntx))
    dq_y = adjust_quant_bias_jax(qimg[1], 1) * dmt[1] * qf_px
    dq_x = adjust_quant_bias_jax(qimg[0], 0) * dmt[0] * qf_px * x_dm_mult \
        + ytox_px * dq_y
    dq_b = adjust_quant_bias_jax(qimg[2], 2) * dmt[2] * qf_px * b_dm_mult \
        + ytob_px * dq_y
    co = jnp.stack([dq_x, dq_y, dq_b])
    # LLF from DC: per-tile DCT of the (cy, cx) DC patch, rescaled
    # (LowestFrequenciesFromDC, dec_transforms-inl.h:688-816)
    dct = dc.reshape(3, nty, cy, ntx, cx).transpose(0, 1, 3, 2, 4)
    llf = jdct2d(dct, cy, cx) / (llf_sy[:, None] * llf_sx[None, :])
    lh, lw = llf.shape[-2:]
    # LLF lives at wide-layout [:lh, :lw]; the tile stores the wide array
    # reshaped row-major to (rows, cols)
    llf_wide = jnp.zeros((3, nty, ntx, wr, wc), llf.dtype)
    llf_wide = llf_wide.at[..., :lh, :lw].set(llf)
    llf_img = llf_wide.reshape(3, nty, ntx, rows, cols).transpose(
        0, 1, 3, 2, 4).reshape(3, h, w)
    mask_img = jnp.tile(llf_mask_tile, (nty, ntx))
    co = jnp.where(mask_img[None], llf_img, co)
    # IDCT: tile layout row-major == wide layout reshaped; reshape back
    tiles = co.reshape(3, nty, rows, ntx, cols).transpose(0, 1, 3, 2, 4)
    wide = tiles.reshape(3, nty, ntx, wr, wc)
    pix = jidct2d(wide, rows, cols)
    return pix.transpose(0, 1, 3, 2, 4).reshape(3, h, w)


def scatter_tiles(acc5, pix, ys, xs):
    """Scatter-add aligned (rows, cols) pixel tiles into a 5D image view
    (3, H//rows, rows, W//cols, cols) at tile indices (ys, xs).

    The separated advanced indices put the tile axis first, so the
    update operand is (n, 3, rows, cols) — pix directly."""
    return acc5.at[:, ys, :, xs, :].add(pix)


def decode_render_image(qimg, qf, dc, ytox_map, ytob_map, dm,
                        inv_global_scale, x_dm_mult, b_dm_mult,
                        gab_kernels, inv_sigma_px, sad_mul, channel_scale,
                        epf_iters, to_rgb=True,
                        pass0_sigma_scale=0.9, pass2_sigma_scale=6.5,
                        extra_tiles=None, dct8_mask=None, tile_shapes=None,
                        size_passes=None, size_shapes=None, class_map=None,
                        true_size=None):
    """Full device decode on image-layout coefficients.

    size_passes: per-size dicts for the dense full-grid plain-DCT passes
    (decode_size_pass); size_shapes: static (rows, cols) per pass;
    class_map: i32[nby, nbx], 0 = DCT8, 1.. = size pass index + 1,
    -1 = batched extra tile. extra_tiles: per-batch dicts for the
    remaining strategies (8x8 specials, > 64px, unaligned); tile_shapes:
    static (rows, cols) per batch. dct8_mask (f32[H, W]) is the legacy
    two-way mask used when size_passes is None."""
    xyb = decode_xyb_image(qimg, qf, dc, ytox_map, ytob_map, dm,
                           inv_global_scale, x_dm_mult, b_dm_mult)
    _, h, w = xyb.shape
    if size_passes:
        cls_px = jnp.repeat(jnp.repeat(class_map, 8, 0), 8, 1)[None]
        nby, nbx = qf.shape
        scaled_px = _block_to_px(
            inv_global_scale / qf.astype(jnp.float32), h, w)
        tile_px = 8 * COLOR_TILE_BLOCKS
        xcc_px = jnp.repeat(jnp.repeat(
            ytox_map.astype(jnp.float32), tile_px, 0), tile_px, 1)[:h, :w] \
            / 84.0
        bcc_px = 1.0 + jnp.repeat(jnp.repeat(
            ytob_map.astype(jnp.float32), tile_px, 0), tile_px, 1)[:h, :w] \
            / 84.0
        for i, (sp, (rows, cols)) in enumerate(
                zip(size_passes, size_shapes)):
            pix = decode_size_pass(
                qimg, scaled_px, dc, xcc_px, bcc_px,
                sp["dm_tile"], x_dm_mult, b_dm_mult, rows, cols,
                sp["llf_sy"], sp["llf_sx"], sp["llf_mask"])
            xyb = jnp.where(cls_px == i + 1, pix, xyb)
    if extra_tiles:
        acc = jnp.zeros_like(xyb)
        for b, (rows, cols) in zip(extra_tiles, tile_shapes):
            if rows == 8 and cols == 8:
                pix = decode_special_tiles(
                    b["q"], b["dc"], b["scaled"], b["x_cc"], b["b_cc"],
                    b["dm"], b["mat"], x_dm_mult, b_dm_mult)
            else:
                pix = decode_big_tiles(
                    b["q"], b["dc"], b["scaled"], b["x_cc"], b["b_cc"],
                    b["dm"], x_dm_mult, b_dm_mult, rows, cols,
                    b["llf_sy"], b["llf_sx"])
            acc5 = acc.reshape(3, h // rows, rows, w // cols, cols)
            acc = scatter_tiles(acc5, pix, b["ys"], b["xs"]).reshape(
                3, h, w)
        if size_passes:
            xyb = jnp.where(cls_px < 0, acc, xyb)
        else:
            xyb = jnp.where(dct8_mask[None] > 0, xyb, acc)
    if true_size is not None:
        # filters mirror at the FRAME edge, not the block-padded edge:
        # overwrite padding rows/cols with the symmetric reflection of
        # the true frame content (image_ops.h:184 Mirror semantics)
        th, tw = true_size
        if th < h:
            n = min(h - th, th)
            xyb = xyb.at[:, th:th + n, :].set(xyb[:, th - n:th, :][:, ::-1])
        if tw < w:
            n = min(w - tw, tw)
            xyb = xyb.at[:, :, tw:tw + n].set(
                xyb[:, :, tw - n:tw][:, :, ::-1])
    if gab_kernels is not None:
        xyb = gaborish_jax(xyb, gab_kernels)
    if epf_iters > 0:
        xyb = epf_jax(xyb, inv_sigma_px, sad_mul, channel_scale, epf_iters,
                      pass0_sigma_scale, pass2_sigma_scale)
    if to_rgb == "u8srgb":
        # full write stage on device: XYB -> linear RGB -> sRGB u8 HWC
        rgb = xyb_to_rgb_jax(xyb)
        low = rgb <= 0.0031308
        srgb = jnp.where(low, rgb * 12.92,
                         1.055 * jnp.maximum(rgb, 1e-12) ** (1 / 2.4)
                         - 0.055)
        u8 = jnp.clip(jnp.round(srgb * 255.0), 0, 255).astype(jnp.uint8)
        return u8.transpose(1, 2, 0)
    if to_rgb:
        return xyb_to_rgb_jax(xyb)
    return xyb


def ycbcr_to_rgb_jax(planes):
    """Full-range BT.601 (stage_ycbcr.cc:31-52) on device: (Cb, Y, Cr)
    planes -> RGB in [0, 1]."""
    cb, y, cr = planes[0], planes[1], planes[2]
    yp = y + jnp.float32(128.0 / 255)
    r = yp + 1.402 * cr
    g = yp + jnp.float32(-0.114 * 1.772 / 0.587) * cb \
        + jnp.float32(-0.299 * 1.402 / 0.587) * cr
    b = yp + 1.772 * cb
    return jnp.stack([r, g, b])


def decode_render_subsampled(qs, dcs, scaled_maps, dm, gab_kernels,
                             inv_sigma_px, sad_mul, channel_scale,
                             shifts, epf_iters=0, gab=False,
                             pass0_sigma_scale=0.9, pass2_sigma_scale=6.5,
                             to_u8=False, true_size=None):
    """Device decode of a chroma-subsampled YCbCr DCT8 frame
    (dec_group.cc:569 quant-from-luma + stage_chroma_upsampling +
    stage_ycbcr): per-channel dequant + batched IDCT8 at native
    resolution, box chroma upsampling, optional Gaborish/EPF, BT.601.

    qs: 3 x i32[nbyc*8, nbxc*8] dense transposed-layout coefficients;
    dcs: 3 x f32[nbyc, nbxc] unquantized DC; scaled_maps: 3 x
    f32[nbyc, nbxc] per-block inv_global_scale/quant (from the LUMA
    quant field); shifts: ((hs, vs) per channel, static).
    """
    planes = []
    h = w = None
    for c in range(3):
        q = qs[c].astype(jnp.float32)
        blocks = image_to_blocks(q[None])[0]  # (nby, nbx, 8, 8)
        scaled = scaled_maps[c][:, :, None, None]
        co = adjust_quant_bias_jax(blocks, c) \
            * dm[c].reshape(1, 1, 8, 8) * scaled
        co = co.at[:, :, 0, 0].set(dcs[c])
        pix = idct8_blocks(co[None])  # (1, nby, nbx, 8, 8)
        plane = blocks_to_image(pix)[0]
        hs, vs = shifts[c]
        if vs:
            plane = jnp.repeat(plane, 1 << vs, axis=0)
        if hs:
            plane = jnp.repeat(plane, 1 << hs, axis=1)
        if c == 1:
            h, w = plane.shape
        planes.append(plane)
    ycc = jnp.stack([p[:h, :w] for p in planes])
    if gab:
        ycc = gaborish_jax(ycc, gab_kernels)
    if epf_iters > 0:
        ycc = epf_jax(ycc, inv_sigma_px, sad_mul, channel_scale,
                      epf_iters, pass0_sigma_scale, pass2_sigma_scale)
    rgb = ycbcr_to_rgb_jax(ycc)
    if true_size is not None:
        rgb = rgb[:, :true_size[0], :true_size[1]]
    if to_u8:
        # YCbCr VarDCT frames carry display-space values: no transfer
        u8 = jnp.clip(jnp.round(rgb * 255.0), 0, 255).astype(jnp.uint8)
        return u8.transpose(1, 2, 0)
    return rgb


def gaborish_jax(xyb, kernels):
    """Decoder-side 3x3 Gaborish blur, per-channel kernels (3, 3, 3).

    Written as 9 shifted weighted adds, which XLA fuses into one
    elementwise kernel with the neighbouring stages."""
    k = jnp.asarray(kernels, dtype=xyb.dtype)
    h, w = xyb.shape[-2:]
    p = jnp.pad(xyb, ((0, 0), (1, 1), (1, 1)), mode="symmetric")
    out = None
    for dy in range(3):
        for dx in range(3):
            term = k[:, dy, dx][:, None, None] * jax.lax.slice(
                p, (0, dy, dx), (3, dy + h, dx + w))
            out = term if out is None else out + term
    return out


_EPF_PLUS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
_EPF0_NEIGHBORS = ((-2, 0), (-1, -1), (-1, 0), (-1, 1), (0, -2), (0, -1),
                   (0, 1), (0, 2), (1, -1), (1, 0), (1, 1), (2, 0))
_EPF12_NEIGHBORS = ((-1, 0), (0, -1), (0, 1), (1, 0))
_EPF_MIN_SIGMA = -3.90524291751269967465540850526098


def _epf_pass_jax(xyb, inv_sigma_px, sad_mul, channel_scale, neighbors,
                  sad_pattern, sigma_scale):
    """One EPF pass on device (stage_epf.cc Weight math). All shifts are
    static slices of one padded array — XLA fuses the stencil. Traced
    under the named scope "epf_pass" so profiles can attribute it."""
    with jax.named_scope("epf_pass"):
        return _epf_pass_body(xyb, inv_sigma_px, sad_mul, channel_scale,
                              neighbors, sad_pattern, sigma_scale)


def _epf_pass_body(xyb, inv_sigma_px, sad_mul, channel_scale, neighbors,
                   sad_pattern, sigma_scale):
    pad = 4
    h, w = xyb.shape[-2:]
    p = jnp.pad(xyb, ((0, 0), (pad, pad), (pad, pad)), mode="symmetric")

    def sh(dy, dx):
        return p[:, pad + dy:pad + dy + h, pad + dx:pad + dx + w]

    cs = jnp.asarray(channel_scale, dtype=xyb.dtype)[:, None, None]
    inv = inv_sigma_px * (sad_mul * sigma_scale * 1.65)
    num = xyb
    den = jnp.ones_like(xyb[0])
    # max |offset| in the sad pattern (the plus shape spans +-1)
    pr = max((max(abs(py), abs(px)) for (py, px) in sad_pattern or ()),
             default=0)
    for (dy, dx) in neighbors:
        if sad_pattern:
            # sad(p) = sum_q |x(p+q) - x(p+(dy,dx)+q)| over the pattern:
            # compute the cross-difference plane D = sum_c cs|x - shift|
            # once on a (h+2pr, w+2pr) window, then sum 5 shifts of D —
            # 3 channel diffs + 5 plane adds instead of 15 channel diffs
            y0, x0 = pad - pr, pad - pr
            hd, wd = h + 2 * pr, w + 2 * pr
            base = p[:, y0:y0 + hd, x0:x0 + wd]
            shifted = p[:, y0 + dy:y0 + dy + hd, x0 + dx:x0 + dx + wd]
            d_plane = (jnp.abs(base - shifted) * cs).sum(axis=0)
            sad = None
            for (py, px) in sad_pattern:
                t = d_plane[pr + py:pr + py + h, pr + px:pr + px + w]
                sad = t if sad is None else sad + t
        else:
            sad = (jnp.abs(xyb - sh(dy, dx)) * cs).sum(axis=0)
        weight = jnp.maximum(0.0, 1.0 + sad * inv)
        num = num + weight[None] * sh(dy, dx)
        den = den + weight
    out = num / den[None]
    skip = inv_sigma_px < _EPF_MIN_SIGMA
    return jnp.where(skip[None], xyb, out)


def epf_jax(xyb, inv_sigma_px, sad_mul, channel_scale, epf_iters,
            pass0_sigma_scale=0.9, pass2_sigma_scale=6.5):
    """Edge-preserving filter chain on device (stage_epf.cc)."""
    if epf_iters == 3:
        xyb = _epf_pass_jax(xyb, inv_sigma_px, sad_mul, channel_scale,
                            _EPF0_NEIGHBORS, _EPF_PLUS, pass0_sigma_scale)
    if epf_iters >= 1:
        xyb = _epf_pass_jax(xyb, inv_sigma_px, sad_mul, channel_scale,
                            _EPF12_NEIGHBORS, _EPF_PLUS, 1.0)
    if epf_iters >= 2:
        xyb = _epf_pass_jax(xyb, inv_sigma_px, sad_mul, channel_scale,
                            _EPF12_NEIGHBORS, None, pass2_sigma_scale)
    return xyb


def decode_render(qcoeffs, qf, dc, ytox_map, ytob_map, dm, inv_global_scale,
                  x_dm_mult, b_dm_mult, gab_kernels, inv_sigma_px, sad_mul,
                  channel_scale, epf_iters, to_rgb=True,
                  pass0_sigma_scale=0.9, pass2_sigma_scale=6.5):
    """Full device decode: dequant + CfL + IDCT + Gaborish + EPF
    (+ XYB->RGB) — the complete djxl pixel path as one XLA program."""
    xyb = decode_xyb(qcoeffs, qf, dc, ytox_map, ytob_map, dm,
                     inv_global_scale, x_dm_mult, b_dm_mult)
    if gab_kernels is not None:
        xyb = gaborish_jax(xyb, gab_kernels)
    if epf_iters > 0:
        xyb = epf_jax(xyb, inv_sigma_px, sad_mul, channel_scale, epf_iters,
                      pass0_sigma_scale, pass2_sigma_scale)
    if to_rgb:
        return xyb_to_rgb_jax(xyb)
    return xyb


def gaborish_inverse_jax(xyb, kernel):
    """5x5 sharpen (GaborishInverse, enc_gaborish.cc:21-49) as 25
    shifted weighted adds; kernel: f32[5, 5] (same for all channels)."""
    k = np.asarray(kernel, dtype=np.float32)
    h, w = xyb.shape[-2:]
    p = jnp.pad(xyb, ((0, 0), (2, 2), (2, 2)), mode="symmetric")
    out = None
    for dy in range(5):
        for dx in range(5):
            term = jnp.float32(k[dy, dx]) * jax.lax.slice(
                p, (0, dy, dx), (3, dy + h, dx + w))
            out = term if out is None else out + term
    return out


def quant_field_jax(y, nby, nbx, base_quant, quant_max):
    """Device port of heuristics.initial_quant_field +
    epf_sharpness_field: per-block masking from local Y-channel
    activity. Returns (quant_field, epf_sharpness)."""
    h, w = nby * 8, nbx * 8
    yp = y[:h, :w]
    gy = jnp.abs(jnp.diff(yp, axis=0, prepend=yp[:1]))
    gx = jnp.abs(jnp.diff(yp, axis=1, prepend=yp[:, :1]))
    grad = (gy + gx).reshape(nby, 8, nbx, 8).mean(axis=(1, 3))
    act = jnp.log1p(grad * 80.0)
    mod = jnp.clip(1.6 - 0.35 * act, 0.55, 1.8)
    qf = jnp.clip(jnp.round(base_quant * mod), 1,
                  quant_max).astype(jnp.int32)
    # uniform sharpness 4: the reference's default outside slow tiers
    # (ComputeARHeuristics, enc_heuristics.cc:901)
    sharp = jnp.full((nby, nbx), 4, dtype=jnp.int32)
    return qf, sharp


def adaptive_quant_field_jax(xyb, nby, nbx, distance, rescale=1.0):
    """Device AdaptiveQuantizationMap: the full per-block float quant
    field (mirrors heuristics.initial_quant_field_full, which mirrors
    enc_adaptive_quantization.cc:85-660) as one fused XLA program —
    elementwise rational polynomials, 4x4 cell sums, a 9-neighbor
    partial sort (FuzzyErosion) and 8x8 block sums all stay on device.
    `distance` is a static Python float (compile-time constant)."""
    from ..vardct.heuristics import (
        _LOG2,
        _SG_MUL,
        _SG_RETMUL,
        _SG_VOFFSET,
    )

    quant_ac = 0.725 / max(distance, 1e-3)
    scale = quant_ac * rescale
    h, w = nby * 8, nbx * 8
    yp = xyb[1][:h, :w]
    xp = xyb[0][:h, :w]
    bp = xyb[2][:h, :w]

    def ratio_cbrt_gamma(v, invert=False):
        eps = 1e-2
        v = jnp.maximum(v, 0.0)
        num = (_SG_RETMUL * 3 * _SG_MUL) * v * v + eps
        den = (_LOG2 * _SG_MUL) * v * v * v + (_SG_VOFFSET * _LOG2 + eps)
        return num / den if invert else den / num

    def block_sum(img):
        return img.reshape(nby, 8, nbx, 8).sum(axis=(1, 3))

    # per-pixel masking diff
    p = jnp.pad(yp, 1, mode="edge")
    base = 0.25 * (p[2:, 1:-1] + p[:-2, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])
    gammac = ratio_cbrt_gamma(yp + 0.019)
    diff = jnp.minimum((gammac * (yp - base)) ** 2, 0.2)
    k_log_offset = 27.505837037000106
    k_mul = 211.66567973503678
    diff = 0.25 * jnp.sqrt(diff * np.sqrt(k_mul * 1e8) + k_log_offset)
    pre = diff.reshape(h // 4, 4, w // 4, 4).sum(axis=(1, 3)) * 0.25

    # FuzzyErosion: weighted 4 smallest of the 9-neighborhood
    mul = max(0.0, min(1.0, (2.0 - distance) / 2.0)) if distance < 2.0 \
        else 0.0
    k = np.array([0.125, 0.10 - mul * 0.10, 0.09 - mul * 0.09,
                  0.06 - mul * 0.06])
    k *= 0.29959705784054957 / k.sum()
    pp = jnp.pad(pre, 1, mode="edge")
    hh, ww = pre.shape
    neigh = jnp.stack([pp[1 + dy:1 + dy + hh, 1 + dx:1 + dx + ww]
                       for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    part = jnp.sort(neigh, axis=0)
    eroded = (k[0] * part[0] + k[1] * part[1] + k[2] * part[2]
              + k[3] * part[3])
    aq = eroded.reshape(nby, 2, nbx, 2).sum(axis=(1, 3))

    # ComputeMask rational polynomial
    v1 = jnp.maximum(aq * 0.80061762862741759, 1e-3)
    v2 = 1.0 / (v1 + 302.59587815579727)
    v3 = 1.0 / (v1 * v1 + 3.7179635626140772)
    v4 = 1.0 / (v1 * v1 + 0.25 * 3.7179635626140772)
    out = (-0.7647 + 9.4708735624378946 * v4 + 17.35036561631863 * v2
           + 6.7943250517376494 * v3)

    # HfModulation: intra-block capped |gradient| sums
    vmin = 0.0206
    dx_ = jnp.minimum(jnp.abs(yp[:, 1:] - yp[:, :-1]), vmin)
    dy_ = jnp.minimum(jnp.abs(yp[1:, :] - yp[:-1, :]), vmin)
    dx_ = jnp.pad(dx_, ((0, 0), (0, 1)))
    dy_ = jnp.pad(dy_, ((0, 1), (0, 0)))
    col = (jnp.arange(w) % 8) != 7
    row = (jnp.arange(h) % 8) != 7
    dx_ = dx_ * col[None, :]
    dy_ = dy_ * row[:, None]
    hf = block_sum(dx_) + block_sum(dy_)
    out = out + hf * -0.38 + 0.42

    # GammaModulation
    r = ratio_cbrt_gamma(yp + 0.16 - xp, invert=True)
    g = ratio_cbrt_gamma(yp + 0.16 + xp, invert=True)
    overall = (block_sum(r) + block_sum(g)) * (0.5 / 64)
    out = out + 0.1005613337192697 * jnp.log2(jnp.maximum(overall, 1e-9))

    # BlueModulation
    k_limit = 0.027121074570634722
    k_offset = 0.084381641171960495
    p_y_eff = bp - (yp + k_offset + jnp.abs(xp))
    contrib = jnp.where(p_y_eff > 0, jnp.minimum(p_y_eff, k_limit), 0.0)
    s = block_sum(contrib)
    s = jnp.where(s >= 32 * k_limit, 64 * k_limit - s, s)
    s = jnp.minimum(s, 15.398788439047934 * k_limit)
    out = out + s * 0.14207000358439159

    # final mapping: exp with distance-dependent dampening
    base_level = 0.48 * scale
    dampen = max(0.0, 1.0 - (distance - 2.0) / 12.0) if distance >= 2.0 \
        else 1.0
    return jnp.exp(out) * (scale * dampen) + (1.0 - dampen) * base_level


def fit_cfl_jax(co, color_factor=84.0, base_b=1.0):
    """Device port of heuristics.fit_cfl: per-64x64-tile least squares of
    the X and B coefficients against Y, LLF excluded.

    co: f32[3, nby, nbx, 8, 8] DCT coefficients, nby/nbx padded to a
    multiple of 8 blocks by the caller. Returns (ytox, ytob) i32 tile maps
    of shape (nby//8, nbx//8)."""
    _, nby, nbx, _, _ = co.shape
    tby, tbx = nby // COLOR_TILE_BLOCKS, nbx // COLOR_TILE_BLOCKS
    mask = jnp.ones((8, 8), dtype=jnp.float32).at[0, 0].set(0.0)
    cm = co * mask
    t = cm.reshape(3, tby, COLOR_TILE_BLOCKS, tbx, COLOR_TILE_BLOCKS, 64)
    ys = t[1]
    denom = (ys * ys).sum(axis=(1, 3, 4)) + 1e-9
    rx = (t[0] * ys).sum(axis=(1, 3, 4)) / denom
    rb = (t[2] * ys).sum(axis=(1, 3, 4)) / denom
    ytox = jnp.clip(jnp.round(rx * color_factor), -128, 127)
    ytob = jnp.clip(jnp.round((rb - base_b) * color_factor), -128, 127)
    return ytox.astype(jnp.int32), ytob.astype(jnp.int32)


def encode_step(rgb, dm_inv, dm, gab_kernel, inv_global_scale, base_quant,
                x_dm_mult, b_dm_mult, quant_max=255,
                color_factor=84.0, adaptive=True, cfl=True, qf_in=None,
                distance=None):
    """Full device-side VarDCT encode step (ComputeCoefficients +
    LossyFrameHeuristics subset): linear RGB -> (qcoeffs, dc, qf,
    ytox_map, ytob_map).

    rgb: f32[3, H, W] with H, W multiples of 8; dm_inv: f32[3, 8, 8]
    quant weights (LLF zeroed); dm: f32[3, 8, 8] dequant matrices.
    DC is returned as the *unquantized* f32[3, nby, nbx] DCT DC
    coefficients (the host quantizes them against the DC quantizer when
    tokenizing the modular DC stream)."""
    xyb = rgb_to_xyb_jax(rgb)
    if qf_in is None and adaptive and distance is not None:
        # full AdaptiveQuantizationMap on device, on the PRE-sharpening
        # opsin image (enc_heuristics.cc:1105); the host only supplies
        # the scalar global scale (fixed 0.39/d anchor)
        _, h, w = xyb.shape
        field = adaptive_quant_field_jax(xyb, h // 8, w // 8, distance)
        qf_in = jnp.clip(field * inv_global_scale + 0.5, 1,
                         quant_max).astype(jnp.int32)
    if gab_kernel is not None:
        xyb = gaborish_inverse_jax(xyb, gab_kernel)
    return encode_step_xyb(xyb, dm_inv, dm, inv_global_scale, base_quant,
                           x_dm_mult, b_dm_mult, quant_max, color_factor,
                           adaptive, cfl, qf_in)


def encode_step_xyb(xyb, dm_inv, dm, inv_global_scale, base_quant,
                    x_dm_mult, b_dm_mult, quant_max=255, color_factor=84.0,
                    adaptive=True, cfl=True, qf_in=None):
    """encode_step starting from the (already sharpened) XYB image —
    the streaming per-DC-group entry point, where the inverse-Gaborish
    border context comes from neighboring chunks."""
    _, h, w = xyb.shape
    nby, nbx = h // 8, w // 8
    if qf_in is not None:
        # precomputed raw quant field (the full AdaptiveQuantizationMap
        # needs the field median to fix the global scale, so the host
        # computes the cheap field and the device does the heavy work)
        qf = qf_in
        _, sharp = quant_field_jax(xyb[1], nby, nbx, base_quant, quant_max)
    elif adaptive:
        qf, sharp = quant_field_jax(xyb[1], nby, nbx, base_quant, quant_max)
    else:
        qf = jnp.full((nby, nbx), jnp.int32(base_quant), dtype=jnp.int32)
        sharp = jnp.full((nby, nbx), 4, dtype=jnp.int32)
    blocks = image_to_blocks(xyb)
    co = dct8_blocks(blocks)
    # CfL tile fit on padded tile grid
    tby = -(-nby // COLOR_TILE_BLOCKS)
    tbx = -(-nbx // COLOR_TILE_BLOCKS)
    if cfl:
        pad_b = (tby * COLOR_TILE_BLOCKS - nby, tbx * COLOR_TILE_BLOCKS - nbx)
        co_p = jnp.pad(co, ((0, 0), (0, pad_b[0]), (0, pad_b[1]), (0, 0),
                            (0, 0)))
        ytox_map, ytob_map = fit_cfl_jax(co_p, color_factor)
    else:
        ytox_map = jnp.zeros((tby, tbx), dtype=jnp.int32)
        ytob_map = jnp.zeros((tby, tbx), dtype=jnp.int32)
    scaled = (inv_global_scale / qf.astype(jnp.float32))[:, :, None, None]
    x_cc = (0.0 + _tile_to_blocks(ytox_map, nby, nbx).astype(jnp.float32)
            / color_factor)[:, :, None, None]
    b_cc = (1.0 + _tile_to_blocks(ytob_map, nby, nbx).astype(jnp.float32)
            / color_factor)[:, :, None, None]
    from ..vardct.frame import _deadzone_thresholds

    def _dz(vals, c):
        # dead-zone thresholds (QuantizeBlockAC, enc_group.cc:46-91)
        thr = jnp.asarray(_deadzone_thresholds(1, 1, c),
                          dtype=jnp.float32)
        r = jnp.round(vals)
        return jnp.where(jnp.abs(vals) < thr, 0.0, r)

    qy = _dz(co[1] * dm_inv[1] / scaled, 1)
    dy = adjust_quant_bias_jax(qy, 1) * dm[1] * scaled
    qx = _dz((co[0] - x_cc * dy) * dm_inv[0] / (scaled * x_dm_mult), 0)
    qb = _dz((co[2] - b_cc * dy) * dm_inv[2] / (scaled * b_dm_mult), 2)
    q = jnp.stack([qx, qy, qb]).astype(jnp.int32)
    q = q.at[:, :, :, 0, 0].set(0)
    dc = co[:, :, :, 0, 0]
    return q, dc, qf, ytox_map, ytob_map, sharp


def encode_coefficients(rgb, qf, dm_inv, dm_y, inv_global_scale, x_dm_mult,
                        b_dm_mult, inv_dc_quant_mul):
    """VarDCT encode compute path: RGB -> XYB -> DCT8 -> quantize
    (ComputeCoefficients analog, enc_group.cc:370-520).

    Returns (qcoeffs i32[3,nby,nbx,8,8], qdc i32[3,nby,nbx]).
    dm_inv: f32[3,8,8] quant weights (LLF zeroed); dm_y: f32[8,8] Y dequant.
    inv_dc_quant_mul: f32[3] = 1 / mul_dc(c).
    """
    xyb = rgb_to_xyb_jax(rgb)
    blocks = image_to_blocks(xyb)
    co = dct8_blocks(blocks)
    scaled = (inv_global_scale / qf.astype(jnp.float32))[:, :, None, None]
    qy = jnp.round(co[1] * dm_inv[1] / scaled)
    dy = adjust_quant_bias_jax(qy, 1) * dm_y * scaled
    qx = jnp.round(co[0] * dm_inv[0] / (scaled * x_dm_mult))
    qb = jnp.round((co[2] - dy) * dm_inv[2] / (scaled * b_dm_mult))
    q = jnp.stack([qx, qy, qb]).astype(jnp.int32)
    # DC: quantize block means with CfL (base_b = 1)
    dc = co[:, :, :, 0, 0]
    qdc_y = jnp.round(dc[1] * inv_dc_quant_mul[1])
    dc_y_deq = qdc_y / inv_dc_quant_mul[1]
    qdc_x = jnp.round(dc[0] * inv_dc_quant_mul[0])
    qdc_b = jnp.round((dc[2] - dc_y_deq) * inv_dc_quant_mul[2])
    qdc = jnp.stack([qdc_x, qdc_y, qdc_b]).astype(jnp.int32)
    q = q.at[:, :, :, 0, 0].set(0)
    return q, qdc
