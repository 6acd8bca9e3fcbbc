"""Multi-chip sharding of the codec compute path.

The reference parallelizes over the 256x256 group grid with a fork-join
thread pool (lib/jxl/base/data_parallel.h, enc_frame.cc:1382). This
design shards the same grid over a jax.sharding.Mesh:

- axis "batch": independent images/frames (data parallel),
- axis "rows":  block-row stripes of one image (the sequence-parallel
  analog). Gaborish/EPF need up to 3 px of halo across stripe seams —
  exchanged with jax.lax.ppermute, mirroring the reference decoder's
  SaveBorders/LoadBorders strip machinery
  (low_memory_render_pipeline.h:52-53).

The halo exchanges are the only collectives (NCCL peer copies between
GPUs); entropy-coded bytes never touch the device.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.pipeline import (
    decode_pixels,
    encode_coefficients,
    xyb_to_rgb_jax,
)
from ..render.pipeline import gaborish_kernel


def _shard_map(f, mesh, in_specs, out_specs):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


HALO = 3  # gaborish 1px + EPF up to 3px; 3 covers the round-1 chain


def make_mesh(devices=None, batch: int = 1):
    """Builds a (batch, rows) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    rows = n // batch
    dev_array = np.array(devices[:batch * rows]).reshape(batch, rows)
    return Mesh(dev_array, ("batch", "rows"))


def _halo_exchange_rows(x, halo: int, axis_name: str):
    """Exchange `halo` rows with the row-neighbors along `axis_name`.

    x: f32[..., rows_local, W]; returns f32[..., rows_local + 2*halo, W]
    with edge-replication at the outer image boundary."""
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.psum(1, axis_name)
    top_strip = x[..., :halo, :]
    bottom_strip = x[..., -halo:, :]
    # send bottom strip down (to idx+1) -> received as top halo
    down = [(i, (i + 1) % n) for i in range(n)]
    up = [(i, (i - 1) % n) for i in range(n)]
    from_above = jax.lax.ppermute(bottom_strip, axis_name, down)
    from_below = jax.lax.ppermute(top_strip, axis_name, up)
    # replicate edges at the image boundary
    edge_top = jnp.repeat(x[..., :1, :], halo, axis=-2)
    edge_bottom = jnp.repeat(x[..., -1:, :], halo, axis=-2)
    top = jnp.where(idx == 0, edge_top, from_above)
    bottom = jnp.where(idx == n - 1, edge_bottom, from_below)
    return jnp.concatenate([top, x, bottom], axis=-2)


def _gaborish_local(xyb, weights):
    outs = []
    for c in range(3):
        k = jnp.asarray(gaborish_kernel(*weights[c]), dtype=xyb.dtype)
        img = jnp.pad(xyb[c], ((0, 0), (1, 1)), mode="edge")  # x only
        out = jax.lax.conv_general_dilated(
            img[None, None], k[None, None], (1, 1), "VALID",
            precision=jax.lax.Precision.HIGHEST)[0, 0]
        outs.append(out)
    return jnp.stack(outs)


GAB_DEFAULT = ((0.115169525, 0.061248592),) * 3  # 1.1 * defaults


def build_sharded_decode(mesh: Mesh, apply_gab: bool = True):
    """Returns a jitted function decoding sharded coefficient tensors to RGB.

    Input shapes (global):
      qcoeffs i32[batch, 3, nby, nbx, 8, 8], qf i32[batch, nby, nbx],
      dc f32[batch, 3, nby, nbx], ytox/ytob i32[batch, tby, tbx],
      dm f32[3, 8, 8] (replicated).
    The nby axis is sharded over "rows", the batch axis over "batch".
    """

    def local_decode(qcoeffs, qf, dc, ytox, ytob, dm):
        def one(qc, qf1, dc1, yx, yb):
            rgb = decode_pixels(qc, qf1, dc1, yx, yb, dm,
                                inv_global_scale=jnp.float32(1024.0),
                                x_dm_mult=1.0, b_dm_mult=1.0)
            return rgb

        rgb = jax.vmap(one)(qcoeffs, qf, dc, ytox, ytob)
        if apply_gab:
            # halo exchange across row-stripes, then 3x3 blur; the VALID
            # convolution consumes the 1-row halo, restoring local height
            padded = _halo_exchange_rows(rgb, 1, "rows")
            rgb = jax.vmap(lambda x: _gaborish_local(x, GAB_DEFAULT))(padded)
        return rgb

    spec_blocks = P("batch", None, "rows", None, None, None)
    spec_qf = P("batch", "rows", None)
    spec_dc = P("batch", None, "rows", None)
    spec_tiles = P("batch", "rows", None)
    spec_out = P("batch", None, "rows", None)
    fn = _shard_map(
        local_decode, mesh,
        (spec_blocks, spec_qf, spec_dc, spec_tiles, spec_tiles,
         P(None, None, None)),
        spec_out)
    return jax.jit(fn)


def build_sharded_encode(mesh: Mesh):
    """Jitted sharded encode compute: RGB -> quantized coefficients + DC.

    rgb f32[batch, 3, H, W] with H sharded over "rows"."""

    def local_encode(rgb, qf, dm_inv, dm_y, inv_dc_mul):
        def one(rgb1, qf1):
            return encode_coefficients(
                rgb1, qf1, dm_inv, dm_y,
                inv_global_scale=jnp.float32(1024.0),
                x_dm_mult=1.0, b_dm_mult=1.0, inv_dc_quant_mul=inv_dc_mul)

        return jax.vmap(one)(rgb, qf)

    fn = _shard_map(
        local_encode, mesh,
        (P("batch", None, "rows", None), P("batch", "rows", None),
         P(None, None, None), P(None, None), P(None)),
        (P("batch", None, "rows", None, None, None),
         P("batch", None, "rows", None)))
    return jax.jit(fn)


def _edge_clamp_halo(a, halo: int, axis_name: str):
    """On the strips holding the global top/bottom image edge, replace
    the halo rows with the adjacent valid edge row of the CURRENT stage
    output. Interior strips are untouched (their halo rows hold true
    neighbor data). This reproduces the unsharded per-stage
    `mode="edge"` padding exactly: chained filter stages must see edge
    replication of the PREVIOUS STAGE'S OUTPUT, not a filtered copy of
    the replicated input."""
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.psum(1, axis_name)
    rows = a.shape[-2]
    r = jnp.arange(rows)[:, None]
    # symmetric mirror (image_ops.h:184 Mirror): halo row i reflects
    # interior row 2*halo-1-i, matching the unsharded stages' padding
    top_mirror = jnp.flip(a[..., halo:2 * halo, :], axis=-2)
    bot_mirror = jnp.flip(a[..., rows - 2 * halo:rows - halo, :], axis=-2)
    top_full = jnp.concatenate([top_mirror, a[..., halo:, :]], axis=-2)
    bot_full = jnp.concatenate([a[..., :rows - halo, :], bot_mirror],
                               axis=-2)
    a = jnp.where((idx == 0) & (r < halo), top_full, a)
    a = jnp.where((idx == n - 1) & (r >= rows - halo), bot_full, a)
    return a


def build_sharded_decode_full(mesh: Mesh, epf_iters: int = 2):
    """Full decode pipeline sharded over (batch, rows): dequant + CfL +
    IDCT + Gaborish + EPF + XYB->RGB with ONE 4-row ppermute halo
    exchange feeding the whole filter chain (Gaborish 1px + EPF passes
    3px — the reference decoder's SaveBorders/LoadBorders strips,
    low_memory_render_pipeline.h:52-53, as collectives). Between
    stages, _edge_clamp_halo refreshes the halo rows on the image-edge
    strips so chained stages see per-stage edge replication.

    Inputs (global): qimg i32[batch, 3, H, W] image-layout coefficients,
    qf i32[batch, nby, nbx], dc f32[batch, 3, nby, nbx],
    ytox/ytob i32[batch, tby, tbx], dm f32[3, 8, 8],
    inv_sigma_px/sad_mul f32[batch, H, W]. H and nby shard over "rows".
    """
    from ..ops.pipeline import (
        _EPF0_NEIGHBORS,
        _EPF12_NEIGHBORS,
        _EPF_PLUS,
        _epf_pass_jax,
        decode_xyb_image,
        gaborish_jax,
        xyb_to_rgb_jax,
    )
    from ..render.pipeline import gaborish_kernel

    # gaborish 1 + EPF1 sad(1)+nb(1) + EPF2 1; pass 0 (epf_iters == 3)
    # adds neighbors(2)+sad(1)
    halo = 8 if epf_iters == 3 else 4
    gab_kernels = np.stack(
        [gaborish_kernel(*GAB_DEFAULT[c]) for c in range(3)]).astype(
            np.float32)
    channel_scale = (40.0, 5.0, 3.5)

    def local_decode(qimg, qf, dc, ytox, ytob, dm, inv_sigma, sad_mul):
        def one(qi, qf1, dc1, yx, yb):
            return decode_xyb_image(qi, qf1, dc1, yx, yb, dm,
                                    inv_global_scale=jnp.float32(1024.0),
                                    x_dm_mult=1.0, b_dm_mult=1.0)

        xyb = jax.vmap(one)(qimg, qf, dc, ytox, ytob)
        # one halo exchange covers the whole filter chain
        xyb_h = _halo_exchange_rows(xyb, halo, "rows")
        sig_h = _halo_exchange_rows(inv_sigma, halo, "rows")
        sad_h = _halo_exchange_rows(sad_mul, halo, "rows")

        x = jax.vmap(lambda a: gaborish_jax(a, gab_kernels))(xyb_h)
        x = _edge_clamp_halo(x, halo, "rows")
        epf_passes = []  # (neighbors, sad_pattern, sigma_scale)
        if epf_iters == 3:
            epf_passes.append((_EPF0_NEIGHBORS, _EPF_PLUS, 0.9))
        if epf_iters >= 1:
            epf_passes.append((_EPF12_NEIGHBORS, _EPF_PLUS, 1.0))
        if epf_iters >= 2:
            epf_passes.append((_EPF12_NEIGHBORS, None, 6.5))
        for nb, sp, ss in epf_passes:
            x = jax.vmap(lambda a, s, d: _epf_pass_jax(
                a, s, d, channel_scale, nb, sp, ss))(x, sig_h, sad_h)
            x = _edge_clamp_halo(x, halo, "rows")
        return jax.vmap(xyb_to_rgb_jax)(x[:, :, halo:-halo, :])

    specs_in = (P("batch", None, "rows", None), P("batch", "rows", None),
                P("batch", None, "rows", None), P("batch", "rows", None),
                P("batch", "rows", None), P(None, None, None),
                P("batch", "rows", None), P("batch", "rows", None))
    fn = _shard_map(local_decode, mesh, specs_in,
                    P("batch", None, "rows", None))
    return jax.jit(fn)


def build_sharded_decode_stream(mesh: Mesh, lf, igs: float, xdm: float,
                                bdm: float, gab_kernels, channel_scale):
    """Sharded device render for a REAL codestream's decoded state:
    same math as ops.pipeline.decode_render_image's DCT8 path + filter
    chain + u8 write stage, with the row-stripe halo exchange. All
    codec parameters come from the stream's signaled headers (loop
    filter lf, quantizer scale igs, CfL dm multipliers, Gaborish
    kernels), so the output must match the single-device render
    pixel for pixel.

    Inputs (global, batch-free): qimg i32[3, H, W], qf i32[nby, nbx],
    dc f32[3, nby, nbx], ytox/ytob i32[tby, tbx], dm f32[3, 8, 8],
    inv_sigma_px/sad_mul f32[H, W]. H (and the row-ish axes) shard over
    "rows"; strips must cut at 64px color-tile boundaries.
    """
    from ..ops.pipeline import (
        _EPF0_NEIGHBORS,
        _EPF12_NEIGHBORS,
        _EPF_PLUS,
        _epf_pass_jax,
        decode_xyb_image,
        gaborish_jax,
        xyb_to_rgb_jax,
    )

    epf_iters = int(lf.epf_iters)
    # total filter radius across the seam: gaborish(1) + EPF pass 0
    # (neighbors 2 + SAD pattern 1 = 3) + pass 1 (2) + pass 2 (1)
    halo = 8 if epf_iters == 3 else 4
    gab = bool(lf.gab)
    p0 = float(lf.epf_pass0_sigma_scale)
    p2 = float(lf.epf_pass2_sigma_scale)
    rows = mesh.shape["rows"]
    if mesh.shape.get("batch", 1) != 1:
        submesh = Mesh(np.asarray(mesh.devices).reshape(-1)[:rows],
                       ("rows",))
    else:
        submesh = mesh
    gabk = np.asarray(gab_kernels, dtype=np.float32)

    def local_decode(qimg, qf, dc, ytox, ytob, dm, inv_sigma, sad_mul):
        xyb = decode_xyb_image(qimg, qf, dc, ytox, ytob, dm,
                               inv_global_scale=jnp.float32(igs),
                               x_dm_mult=jnp.float32(xdm),
                               b_dm_mult=jnp.float32(bdm))
        x = _halo_exchange_rows(xyb, halo, "rows")
        sig_h = _halo_exchange_rows(inv_sigma, halo, "rows")
        sad_h = _halo_exchange_rows(sad_mul, halo, "rows")
        if gab:
            x = gaborish_jax(x, gabk)
            x = _edge_clamp_halo(x, halo, "rows")
        epf_passes = []
        if epf_iters == 3:
            epf_passes.append((_EPF0_NEIGHBORS, _EPF_PLUS, p0))
        if epf_iters >= 1:
            epf_passes.append((_EPF12_NEIGHBORS, _EPF_PLUS, 1.0))
        if epf_iters >= 2:
            epf_passes.append((_EPF12_NEIGHBORS, None, p2))
        for nb, sp, ss in epf_passes:
            x = _epf_pass_jax(x, sig_h, sad_h, channel_scale, nb, sp, ss)
            x = _edge_clamp_halo(x, halo, "rows")
        rgb = xyb_to_rgb_jax(x[:, halo:-halo, :])
        low = rgb <= 0.0031308
        srgb = jnp.where(low, rgb * 12.92,
                         1.055 * jnp.maximum(rgb, 1e-12) ** (1 / 2.4)
                         - 0.055)
        return jnp.clip(jnp.round(srgb * 255.0), 0, 255).astype(jnp.uint8)

    specs_in = (P(None, "rows", None), P("rows", None),
                P(None, "rows", None), P("rows", None),
                P("rows", None), P(None, None, None),
                P("rows", None), P("rows", None))
    fn = _shard_map(local_decode, submesh, specs_in,
                    P(None, "rows", None))
    return jax.jit(fn)


def make_sharded_chunk_step(mesh: Mesh):
    """The streaming encoder's per-DC-group device step (encode_step_xyb)
    under shard_map over mesh "rows" — the real-codec multi-chip encode
    decomposition (enc_frame.cc:1975 EncodeFrameStreaming as SPMD).

    Every op in the step is row-local at 256-row granularity (DCT blocks,
    64px CfL tiles and the quant field all divide evenly), so the sharded
    step is bit-identical to the single-device step; the host entropy
    stage downstream is unchanged and the emitted codestream matches the
    sequential encoder byte for byte (asserted by dryrun_multichip).
    """
    from ..ops.pipeline import encode_step_xyb

    rows = mesh.shape["rows"]
    batch = mesh.shape.get("batch", 1)
    if batch != 1:
        submesh = Mesh(np.asarray(mesh.devices).reshape(-1)[:rows],
                       ("rows",))
    else:
        submesh = mesh

    def local_step(xyb, dm_inv, dm, inv_global_scale, base_quant,
                   x_dm_mult, b_dm_mult, qf_in):
        return encode_step_xyb(xyb, dm_inv, dm, inv_global_scale,
                               base_quant, x_dm_mult, b_dm_mult,
                               qf_in=qf_in)

    fn = _shard_map(
        local_step, submesh,
        (P(None, "rows", None), P(None, None, None), P(None, None, None),
         P(), P(), P(), P(), P("rows", None)),
        (P(None, "rows", None, None, None), P(None, "rows", None),
         P("rows", None), P("rows", None), P("rows", None),
         P("rows", None)))
    return jax.jit(fn)
