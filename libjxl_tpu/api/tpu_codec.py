"""Device-accelerated encode/decode: device compute, host entropy coding.

The heavy per-pixel math — sRGB->linear->XYB, inverse Gaborish, adaptive
quant field, batched 8x8 DCT (einsum), CfL tile fit, quantization,
and on decode dequant+CfL+IDCT — runs as ONE jitted XLA program
(ops/pipeline.encode_step / decode_xyb). Only the serial, byte-oriented
work (rANS token streams, section/TOC assembly) stays on host, mirroring
the natural split in the reference between enc_group.cc SIMD loops and
enc_ans.cc stream writing.

Produces/consumes exactly the same codestream format as the pure-host
api.codestream functions; streams from either are decodable by both.
On typical content the device encoder is byte-identical to the host
encoder (see tests/test_tpu_codec.py); on large noisy images a handful
of coefficients sitting exactly on a quantization rounding boundary may
flip (float32 device math vs float64 host math), changing bytes without
measurable quality impact.
"""

from __future__ import annotations

import functools

import numpy as np

from ..io.bits import BitReader, BitWriter
from ..io.headers import CodecMetadata, SizeHeader
from .codestream import (
    parse_codestream_header,
    write_codestream_header,
)

K_AC_QUANT = 0.79
K_DC_QUANT = 1.095924047623553


@functools.lru_cache(maxsize=1)
def _jitted():
    import jax
    import jax.numpy as jnp

    from ..ops import pipeline as pl
    from ..vardct.heuristics import gaborish_inverse_kernel

    gab_kernel = gaborish_inverse_kernel(1.0).astype(np.float32)

    @functools.partial(jax.jit,
                       static_argnames=("adaptive", "cfl", "gab",
                                        "distance"))
    def enc(rgb, dm_inv, dm, inv_global_scale, base_quant, x_dm_mult,
            b_dm_mult, qf_in=None, adaptive=True, cfl=True, gab=True,
            distance=None):
        q, dc, qf, ytox, ytob, sharp = pl.encode_step(
            rgb, dm_inv, dm, gab_kernel if gab else None,
            inv_global_scale, base_quant, x_dm_mult, b_dm_mult,
            adaptive=adaptive, cfl=cfl, qf_in=qf_in, distance=distance)
        # image-layout coefficients + per-position zero counts ON DEVICE:
        # the host entropy coder consumes these directly, skipping the
        # ~100 MB transpose/astype copies of the block tensor
        qimg = pl.blocks_to_image(q)
        nz = (q == 0).sum(axis=(1, 2)).reshape(3, 64).astype(jnp.int32)
        return qimg, nz, dc, qf, ytox, ytob, sharp

    @jax.jit
    def dec(qcoeffs, qf, dc, ytox_map, ytob_map, dm, inv_global_scale,
            x_dm_mult, b_dm_mult):
        return pl.decode_xyb(qcoeffs, qf, dc, ytox_map, ytob_map, dm,
                             inv_global_scale, x_dm_mult, b_dm_mult)

    @functools.partial(jax.jit, static_argnames=("epf_iters",))
    def dec_full(qcoeffs, qf, dc, ytox_map, ytob_map, dm, inv_global_scale,
                 x_dm_mult, b_dm_mult, gab_kernels, inv_sigma_px, sad_mul,
                 channel_scale, epf_iters, pass0_scale, pass2_scale):
        return pl.decode_render(qcoeffs, qf, dc, ytox_map, ytob_map, dm,
                                inv_global_scale, x_dm_mult, b_dm_mult,
                                gab_kernels, inv_sigma_px, sad_mul,
                                channel_scale, epf_iters, to_rgb=False,
                                pass0_sigma_scale=pass0_scale,
                                pass2_sigma_scale=pass2_scale)

    @functools.partial(jax.jit,
                       static_argnames=("epf_iters", "tile_shapes", "gab",
                                        "to_rgb", "size_shapes",
                                        "true_size"))
    def dec_image(qimg, qf, dc, ytox_map, ytob_map, dm, inv_global_scale,
                  x_dm_mult, b_dm_mult, gab_kernels, inv_sigma_px, sad_mul,
                  channel_scale, epf_iters, pass0_scale, pass2_scale,
                  extra_tiles, dct8_mask, size_passes, class_map,
                  tile_shapes=(), gab=True, to_rgb=False, size_shapes=(),
                  true_size=None):
        return pl.decode_render_image(
            qimg, qf, dc, ytox_map, ytob_map, dm, inv_global_scale,
            x_dm_mult, b_dm_mult, gab_kernels if gab else None,
            inv_sigma_px, sad_mul, channel_scale, epf_iters, to_rgb=to_rgb,
            pass0_sigma_scale=pass0_scale, pass2_sigma_scale=pass2_scale,
            extra_tiles=extra_tiles, dct8_mask=dct8_mask,
            tile_shapes=tile_shapes, size_passes=size_passes,
            size_shapes=size_shapes, class_map=class_map,
            true_size=true_size)

    @jax.jit
    def srgb2lin(srgb):
        import jax.numpy as jnp

        low = srgb <= 0.04045
        return jnp.where(low, srgb / 12.92,
                         ((srgb + 0.055) / 1.055) ** 2.4)

    return enc, dec, dec_full, srgb2lin, dec_image


@functools.lru_cache(maxsize=1)
def _jitted_sub():
    """Jitted device render for chroma-subsampled YCbCr frames."""
    import jax

    from ..ops import pipeline as pl

    @functools.partial(jax.jit,
                       static_argnames=("shifts", "epf_iters", "gab",
                                       "to_u8", "true_size"))
    def dec_sub(qs, dcs, scaled_maps, dm, gab_kernels, inv_sigma_px,
                sad_mul, channel_scale, shifts, epf_iters=0, gab=False,
                pass0_scale=0.9, pass2_scale=6.5, to_u8=False,
                true_size=None):
        return pl.decode_render_subsampled(
            qs, dcs, scaled_maps, dm, gab_kernels, inv_sigma_px, sad_mul,
            channel_scale, shifts, epf_iters=epf_iters, gab=gab,
            pass0_sigma_scale=pass0_scale, pass2_sigma_scale=pass2_scale,
            to_u8=to_u8, true_size=true_size)

    return dec_sub


def encode_lossy_tpu(image: np.ndarray, distance: float = 1.0,
                     adaptive_quant: bool = True, cfl: bool = True,
                     gaborish: bool = None, epf: int = None) -> bytes:
    """Encode an sRGB uint8 (H, W, 3) image lossily with the device
    compute path. Returns a bare JPEG XL codestream (DCT8 strategy).
    gaborish/epf: loop-filter overrides (None = encoder defaults)."""
    from .codestream import _calibrated_distance

    public_distance = distance
    distance = _calibrated_distance(distance)
    from ..io.frame_header import (
        CT_XYB,
        ENC_VARDCT,
        FT_REGULAR,
        FrameHeader,
    )
    from ..vardct.ctx import QUANT_MAX
    from ..vardct.frame import Quantizer, encode_vardct_frame
    from ..vardct.quant_weights import DequantMatrices

    if image.ndim == 2:
        image = np.repeat(image[:, :, None], 3, axis=2)
    h, w, _ = image.shape
    meta = CodecMetadata()
    meta.size = SizeHeader().set(w, h)
    writer = BitWriter()
    write_codestream_header(writer, meta)
    fh = FrameHeader(meta)
    fh.all_default = False
    fh.frame_type = FT_REGULAR
    fh.encoding = ENC_VARDCT
    fh.color_transform = CT_XYB
    fh.flags = 0  # adaptive DC smoothing on (see codestream.encode_lossy)
    fh.loop_filter.all_default = False
    fh.loop_filter.gab = True if gaborish is None else bool(gaborish)
    fh.loop_filter.epf_iters = 2 if epf is None else max(0, min(3, epf))

    fd = fh.frame_dimensions()
    # pad to block multiple (device needs static 8-multiple shapes)
    srgb = image.astype(np.float32) / 255.0
    srgb = np.moveaxis(srgb, -1, 0)
    pad_y = fd.ysize_padded - h
    pad_x = fd.xsize_padded - w
    srgb = np.pad(srgb, ((0, 0), (0, pad_y), (0, pad_x)), mode="edge")

    # quantizer setup on host (must match encode_vardct_frame's):
    # the full adaptive field needs its median to fix the global scale,
    # so the cheap field math runs host-side in float64 exactly like the
    # host encoder; the heavy DCT/CfL/quantize work stays on device
    matrices = DequantMatrices()
    quantizer = Quantizer(matrices)
    quant_ac = K_AC_QUANT / distance
    from ..vardct.frame import initial_quant_dc

    quant_dc = initial_quant_dc(public_distance)
    qf_arr = None
    if adaptive_quant:
        # the full AdaptiveQuantizationMap runs ON DEVICE inside the
        # jitted encode step (ops/pipeline.py adaptive_quant_field_jax,
        # computed on the PRE-sharpening opsin image per
        # enc_heuristics.cc:1105); the host only fixes the scalar
        # global scale from the 0.39/d anchor (enc_heuristics.cc:1115)
        quant_median = 0.39 / distance
        quantizer.compute_global_scale_and_quant(quant_dc, quant_median)
        base_quant = 0  # unused on the device adaptive path
    else:
        quantizer.compute_global_scale_and_quant(quant_dc, quant_ac)
        base_quant = max(1, min(QUANT_MAX, int(
            quant_ac * quantizer.inv_global_scale + 0.5)))
    dm = np.stack([matrices.dequant_matrix(0, c)
                   for c in range(3)]).astype(np.float32)
    dm_inv = np.stack([matrices.inv_matrix(0, c)
                       for c in range(3)]).astype(np.float32)
    x_dm_mult = (1 / 1.25) ** (fh.x_qm_scale - 2.0)
    b_dm_mult = (1 / 1.25) ** (fh.b_qm_scale - 2.0)

    enc, _, _, srgb2lin, _ = _jitted()
    rgb = srgb2lin(srgb)
    qimg, nz, dc, qf, ytox_map, ytob_map, sharp = enc(
        rgb, dm_inv, dm, np.float32(quantizer.inv_global_scale),
        np.float32(base_quant), np.float32(x_dm_mult),
        np.float32(b_dm_mult), qf_in=qf_arr,
        adaptive=adaptive_quant, cfl=cfl, gab=fh.loop_filter.gab,
        distance=float(distance) if adaptive_quant else None)
    # one device->host fetch of all outputs (whole-array copies measured
    # 2x faster on the H100 than concurrent row-chunk fetches, PERF.md)
    import jax

    qimg, nz, dc, qf, ytox_map, ytob_map, sharp = jax.device_get(
        (qimg, nz, dc, qf, ytox_map, ytob_map, sharp))
    precomputed = {
        "quant_median": (quant_median if adaptive_quant
                         else K_AC_QUANT / distance),
        "qimg": qimg,
        "nz": nz,
        "dc": dc,
        "qf": qf,
        "ytox_map": ytox_map,
        "ytob_map": ytob_map,
        "sharp": sharp,
    }
    encode_vardct_frame(writer, None, fh, distance=distance,
                        precomputed=precomputed,
                        dc_distance=public_distance)
    return writer.get_bytes()


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _gather_tiles(qimg, ys, xs, rows, cols, pad):
    """(pad, 3, rows*cols) int32 tiles from the dense coefficient image
    at block origins (ys, xs) — one fancy-indexed numpy gather."""
    n = len(ys)
    w = qimg.shape[-1]
    base = (ys * 8 * w + xs * 8).astype(np.int64)
    pattern = (np.arange(rows)[:, None] * w
               + np.arange(cols)[None, :]).reshape(-1)
    idx = base[:, None] + pattern[None, :]
    flat = qimg.reshape(3, -1)
    out = np.zeros((pad, 3, rows * cols), dtype=np.int32)
    out[:n] = flat[:, idx].transpose(1, 0, 2)
    return out


def _prepare_batches(state, qimg):
    """Group non-DCT8 blocks by strategy into padded device batches.

    Returns (extra_tiles pytree list, tile_shapes, dct8_mask f32[H, W])
    or None when an origin is not aligned to its own tile size (host
    fallback; real encoders always emit aligned merges)."""
    from ..ops.dct import resample_scales
    from ..ops.pipeline import special_matrix
    from ..vardct import ac_strategy as acs

    fd = state.fd
    nby, nbx = fd.ysize_blocks, fd.xsize_blocks
    inv_gs = state.quantizer.inv_global_scale
    strat_map = state.strategy
    origins = state.is_origin
    dct8_mask = (strat_map == acs.DCT).astype(np.float32)
    used = np.unique(strat_map[origins])
    extra, shapes = [], []
    size_passes, size_shapes = [], []
    class_map = np.zeros((nby, nbx), dtype=np.int32)
    for s in used:
        s = int(s)
        if s == acs.DCT:
            continue
        cx, cy = acs.COVERED_X[s], acs.COVERED_Y[s]
        rows, cols = cy * 8, cx * 8
        kind = acs.QUANT_TABLE[s]
        pos = np.argwhere(origins & (strat_map == s))
        ys, xs = pos[:, 0], pos[:, 1]
        n = len(ys)
        if (cy > 1 and (ys % cy).any()) or (cx > 1 and (xs % cx).any()):
            return None  # unaligned origin: host render
        if (nby * 8) % rows != 0 or (nbx * 8) % cols != 0:
            # the batched scatter also reshapes the padded grid by the
            # tile size; odd-size images with large merges render on host
            if max(rows, cols) > 8:
                return None
        plain = s in (acs.DCT16X16, acs.DCT32X32, acs.DCT16X8, acs.DCT8X16,
                      acs.DCT32X8, acs.DCT8X32, acs.DCT32X16, acs.DCT16X32,
                      acs.DCT64X64, acs.DCT64X32, acs.DCT32X64)
        if plain and max(rows, cols) <= 64 \
                and (nby * 8) % rows == 0 and (nbx * 8) % cols == 0:
            # dense pass needs the padded grid divisible by the tile;
            # otherwise the strategy renders via the batched tile path
            # dense full-grid pass (decode_size_pass): no gathers
            from ..ops.dct import resample_scales as _rs

            wr, wc = min(rows, cols), max(rows, cols)
            dm = np.stack([state.matrices.dequant_matrix(kind, c)
                           for c in range(3)]).astype(np.float32)
            dm_tile = dm.reshape(3, rows, cols)
            lh, lw = min(cy, cx), max(cy, cx)
            mask_wide = np.zeros((wr, wc), dtype=bool)
            mask_wide[:lh, :lw] = True
            size_passes.append(dict(
                dm_tile=dm_tile,
                llf_sy=_rs(lh, lh * 8).astype(np.float32),
                llf_sx=_rs(lw, lw * 8).astype(np.float32),
                llf_mask=mask_wide.reshape(rows, cols)))
            size_shapes.append((rows, cols))
            class_map[strat_map == s] = len(size_passes)
            continue
        class_map[strat_map == s] = -1
        pad = _next_pow2(n)
        q = _gather_tiles(qimg, ys, xs, rows, cols, pad)
        quant = state.raw_quant_field[ys, xs].astype(np.float64)
        scaled = np.zeros(pad, dtype=np.float32)
        scaled[:n] = inv_gs / quant
        ty, tx = ys // 8, xs // 8
        x_cc = np.zeros(pad, dtype=np.float32)
        b_cc = np.zeros(pad, dtype=np.float32)
        x_cc[:n] = state.ytox(state.ytox_map[ty, tx].astype(np.float64))
        b_cc[:n] = state.ytob(state.ytob_map[ty, tx].astype(np.float64))
        ys_p = np.zeros(pad, dtype=np.int32)
        xs_p = np.zeros(pad, dtype=np.int32)
        ys_p[:n] = ys // cy  # tile indices in the (rows, cols) grid
        xs_p[:n] = xs // cx
        dm = np.stack([state.matrices.dequant_matrix(kind, c)
                       for c in range(3)]).astype(np.float32)
        batch = dict(ys=ys_p, xs=xs_p, scaled=scaled, x_cc=x_cc, b_cc=b_cc)
        if rows == 8 and cols == 8:
            batch["q"] = q
            batch["dm"] = dm.reshape(3, 64)
            batch["mat"] = special_matrix(s)
            dc = np.zeros((pad, 3), dtype=np.float32)
            dc[:n] = state.dc[:, ys, xs].T
            batch["dc"] = dc
        else:
            wr, wc = min(rows, cols), max(rows, cols)
            batch["q"] = q.reshape(pad, 3, wr, wc)
            batch["dm"] = dm
            dc = np.zeros((pad, 3, cy, cx), dtype=np.float32)
            dcp = np.pad(state.dc, ((0, 0), (0, cy), (0, cx)))
            dc_pat = (np.arange(cy)[:, None] * (nbx + cx)
                      + np.arange(cx)[None, :]).reshape(-1)
            dc_idx = (ys * (nbx + cx) + xs)[:, None] + dc_pat[None, :]
            dc[:n] = dcp.reshape(3, -1)[:, dc_idx].transpose(
                1, 0, 2).reshape(n, 3, cy, cx)
            batch["dc"] = dc
            lh, lw = min(cy, cx), max(cy, cx)
            batch["llf_sy"] = resample_scales(lh, lh * 8).astype(np.float32)
            batch["llf_sx"] = resample_scales(lw, lw * 8).astype(np.float32)
        extra.append(batch)
        shapes.append((rows, cols))
    mask_px = np.repeat(np.repeat(dct8_mask, 8, 0), 8, 1)
    return (extra, tuple(shapes), mask_px,
            size_passes, tuple(size_shapes), class_map)


def decode_tpu(data: bytes):
    """Decode a bare codestream with the device render path (all 27 AC
    strategies batched on device; host does entropy decode only).

    Returns (uint8 image (H, W, 3), CodecMetadata)."""
    from ..io.frame_header import FrameHeader
    from ..vardct.frame import decode_vardct_frame

    r = BitReader(data)
    meta = parse_codestream_header(r)
    fh = FrameHeader(meta)
    fh.read(r)
    out = {}
    chans = decode_vardct_frame(r, fh, render_fn=make_device_render(fh, out),
                                want_qimg=True)
    if "u8" in out:
        return out["u8"], meta
    from ..ops.xyb import linear_to_srgb_u8

    return linear_to_srgb_u8(np.stack(chans, axis=-1)), meta


_BATCH_PROGS = {}


def decode_tpu_batch(streams, num_threads: int = 0):
    """Decode N same-geometry all-DCT8 VarDCT streams with ONE vmapped
    device dispatch (the serving path: host entropy decode per stream,
    then every image's dequant + IDCT + Gaborish + EPF + sRGB u8 write
    runs as one XLA program over the batch axis — amortizing dispatch).

    Returns a list of uint8 (H, W, 3) images in input order. Raises
    JXLError when the batch is not homogeneous (different geometry,
    non-DCT8 strategies, mismatched filter/dequant config) — callers
    fall back to per-stream decode().
    """
    prog, args = prepare_tpu_batch(streams, num_threads=num_threads)
    return list(np.asarray(prog(*args)))


def decode_tpu_pipelined(streams, batch_size: int = 16,
                         num_threads: int = 0):
    """Pipelined serving decode: host entropy of batch k+1 overlaps the
    device render + full-pixel readback of batch k.

    The serving path's stages hold disjoint resources — host CPU (rANS
    entropy decode; native C entered via ctypes, so the GIL is released
    for the duration), the device (the batched render program), and the
    host<->device link (argument staging + u8 pixel readback). A
    two-deep pipeline keeps all three busy: the caller's thread
    entropy-decodes batch k+1 while a single worker thread dispatches
    and reads back batch k, so steady-state throughput is
    max(entropy, render + readback) rather than their sum. The
    reference gets the same overlap from one pool running entropy and
    render per group (dec_frame.cc:568,716); here the stages live on
    different processors, so the overlap is an explicit pipeline.

    Returns a list of uint8 (H, W, 3) images in input order. Raises
    JXLError (like decode_tpu_batch) when any batch falls outside the
    homogeneous all-DCT8 serving scope — callers fall back to
    per-stream decode().
    """
    import concurrent.futures as cf

    if not streams:
        return []
    bs = max(1, int(batch_size))
    out = [None] * len(streams)

    def drain(p):
        fut, start, cnt = p
        px = fut.result()
        for j in range(cnt):
            out[start + j] = px[j]

    import os
    import time

    dbg = os.environ.get("LIBJXL_TPU_PIPE_DEBUG") == "1"

    def timed_fetch(prog, args):
        t0 = time.time()
        dev = prog(*args)
        t1 = time.time()
        px = np.asarray(dev)
        if dbg:
            import sys

            print(f"pipe: dispatch {t1 - t0:.2f}s readback "
                  f"{time.time() - t1:.2f}s", file=sys.stderr,
                  flush=True)
        return px

    with cf.ThreadPoolExecutor(max_workers=1) as ex:
        pending = None
        try:
            for start in range(0, len(streams), bs):
                chunk = streams[start:start + bs]
                # host stage (this thread): entropy decode + staging
                t0 = time.time()
                prog, args = prepare_tpu_batch(chunk,
                                               num_threads=num_threads)
                if dbg:
                    import sys

                    print(f"pipe: prepare {time.time() - t0:.2f}s",
                          file=sys.stderr, flush=True)
                # device stage (worker): dispatch + pixel readback; we
                # submit BEFORE draining the previous batch so the
                # worker rolls straight from batch k-1 into batch k
                job = ex.submit(timed_fetch, prog, args)
                if pending is not None:
                    drain(pending)
                pending = (job, start, len(chunk))
        finally:
            if pending is not None:
                drain(pending)
    return out


def decode_tpu_batch_sharded(streams, mesh=None, num_threads: int = 0):
    """Multi-chip serving decode: the batched program data-parallel over
    a device mesh (each chip renders batch_size/n_chips images; XLA
    inserts no collectives — the batch axis is embarrassingly
    parallel). `mesh` defaults to a 1-D mesh over all devices; the
    batch must divide evenly across them."""
    import jax
    from jax.sharding import Mesh

    from ..base.status import JXLError

    if mesh is None:
        devs = jax.devices()
        mesh = Mesh(np.array(devs), ("batch",))
    n_dev = int(np.prod([mesh.shape[k] for k in mesh.shape]))
    if len(streams) % n_dev:
        raise JXLError("sharded batch decode: batch size must divide "
                       f"across {n_dev} devices")
    prog, args = prepare_tpu_batch(streams, num_threads=num_threads)
    out = np.asarray(prog(*place_batch(args, mesh)))
    return [out[i] for i in range(len(streams))]


# vmap axes of prepare_tpu_batch's program: per-stream arguments carry
# the batch axis, the trailing dequant table, Gaborish kernel and EPF
# border map are shared
BATCH_IN_AXES = (0, 0, 0, 0, 0, 0, 0, None, None, None)


def place_batch(args, mesh):
    """Put prepare_tpu_batch's arguments on a 1-D mesh: the batch axis
    split across its devices, the shared arguments replicated."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    axis = next(iter(mesh.shape))
    batched = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    return tuple(jax.device_put(a, repl if ax is None else batched)
                 for a, ax in zip(args, BATCH_IN_AXES, strict=True))


def prepare_tpu_batch(streams, num_threads: int = 0):
    """Entropy-decode `streams` and build the batched device program.

    Returns (prog, args): `np.asarray(prog(*args))` renders every
    stream's pixels in one dispatch (bench times this directly)."""
    import jax

    from ..base.status import JXLError
    from ..io.frame_header import FrameHeader
    from ..ops import pipeline as pl
    from ..render.pipeline import (_sad_mul_map, compute_sigma,
                                   gaborish_kernel)
    from ..vardct import ac_strategy as acs
    from ..vardct.frame import decode_vardct_frame

    if not streams:
        raise JXLError("batch decode: empty stream list")
    states, fhs = [], []
    for data in streams:
        r = BitReader(data)
        meta = parse_codestream_header(r)
        if not meta.m.xyb_encoded or meta.m.orientation != 1 \
                or meta.m.bit_depth.bits_per_sample > 8:
            raise JXLError("batch decode: stream needs host stages")
        if meta.m.num_extra_channels:
            raise JXLError("batch decode: extra channels")
        if meta.m.color_encoding.want_icc:
            raise JXLError("batch decode: CMS output stage")
        if meta.m.have_preview:
            from .codestream import _skip_or_decode_preview

            _skip_or_decode_preview(r, meta)
        fh = FrameHeader(meta)
        fh.read(r)
        cap = {}

        def capture(state, cap=cap):
            cap["state"] = state
            state.restoration_done = True
            state.device_output_done = True

        decode_vardct_frame(r, fh, render_fn=capture, want_qimg=True,
                            num_threads=num_threads)
        states.append(cap["state"])
        fhs.append(fh)
    fd0 = states[0].fd
    lf0 = fhs[0].loop_filter
    dm0 = np.stack([states[0].matrices.dequant_matrix(0, c)
                    for c in range(3)]).astype(np.float32)
    for st, fh in zip(states, fhs):
        fd = st.fd
        if (fd.ysize, fd.xsize) != (fd0.ysize, fd0.xsize):
            raise JXLError("batch decode: mixed geometry")
        if np.any(st.strategy[st.is_origin] != acs.DCT):
            raise JXLError("batch decode: non-DCT8 strategies")
        if getattr(st, "qimg", None) is None:
            if not st.qblocks:
                raise JXLError("batch decode: no coefficients")
            # single-group streams skip the bulk entropy path: assemble
            # the dense image from the per-block dict
            nby_, nbx_ = fd.ysize_blocks, fd.xsize_blocks
            plane5 = np.zeros((3, nby_, 8, nbx_, 8), dtype=np.int32)
            keys = np.array(list(st.qblocks.keys()), dtype=np.int64)
            vals = np.stack([np.asarray(v) for v in
                             st.qblocks.values()]).astype(np.int32)
            plane5[:, keys[:, 0], :, keys[:, 1], :] = \
                vals.reshape(-1, 3, 8, 8)
            st.qimg = plane5.reshape(3, nby_ * 8, nbx_ * 8)
        if st.patches is not None or st.splines is not None \
                or st.noise_lut is not None or fh.upsampling != 1:
            raise JXLError("batch decode: post-render features")
        if getattr(st, "color_factor", 84) != 84 \
                or getattr(st, "base_x", 0.0) != 0.0 \
                or getattr(st, "base_b", 1.0) != 1.0:
            raise JXLError("batch decode: custom color correlation")
        lf = fh.loop_filter
        if (lf.epf_iters, lf.gab) != (lf0.epf_iters, lf0.gab) or any(
                getattr(lf, f) != getattr(lf0, f) for f in (
                    "epf_pass0_sigma_scale", "epf_pass2_sigma_scale",
                    "epf_border_sad_mul") if lf.epf_iters):
            raise JXLError("batch decode: mixed filter config")
        dm = np.stack([st.matrices.dequant_matrix(0, c)
                       for c in range(3)]).astype(np.float32)
        if not np.array_equal(dm, dm0):
            raise JXLError("batch decode: mixed dequant tables")
        if (st.x_dm_mult, st.b_dm_mult) != (states[0].x_dm_mult,
                                            states[0].b_dm_mult):
            raise JXLError("batch decode: mixed qm scales")
    nby, nbx = fd0.ysize_blocks, fd0.xsize_blocks
    h, w = nby * 8, nbx * 8
    B = len(states)
    qimg = np.stack([st.qimg for st in states])
    if np.abs(qimg).max() < (1 << 15):
        # quantized AC coefficients fit int16 on real streams: halves
        # the dominant staging upload (the device program widens back)
        qimg = qimg.astype(np.int16)
    qf = np.stack([st.raw_quant_field for st in states]).astype(np.int32)
    dc = np.stack([st.dc for st in states]).astype(np.float32)
    ytox = np.stack([st.ytox_map for st in states]).astype(np.int32)
    ytob = np.stack([st.ytob_map for st in states]).astype(np.int32)
    igs = np.array([st.quantizer.inv_global_scale for st in states],
                   dtype=np.float32)
    xdm = np.float32(states[0].x_dm_mult)
    bdm = np.float32(states[0].b_dm_mult)
    if lf0.epf_iters > 0:
        # per-BLOCK sigma uploads (64x less than per-pixel); the device
        # program repeats to pixel resolution
        isp = np.stack([
            compute_sigma(
                fh.loop_filter, st.quantizer.global_scale_float,
                st.raw_quant_field, st.epf_sharpness).astype(np.float32)
            for st, fh in zip(states, fhs)])
        sad = _sad_mul_map(h, w, lf0.epf_border_sad_mul).astype(
            np.float32)
    else:
        isp = np.zeros((B, nby, nbx), dtype=np.float32)
        sad = np.ones((h, w), dtype=np.float32)
    gabk = np.stack([gaborish_kernel(getattr(lf0, f"gab_{ch}_weight1"),
                                     getattr(lf0, f"gab_{ch}_weight2"))
                     for ch in "xyb"]).astype(np.float32) \
        if lf0.gab else np.zeros((3, 3, 3), dtype=np.float32)
    cs = tuple(np.float32(v) for v in lf0.epf_channel_scale)
    ts = (fd0.ysize, fd0.xsize) if (fd0.ysize, fd0.xsize) != (h, w) \
        else None
    key = (B, h, w, int(lf0.epf_iters), bool(lf0.gab), ts,
           float(xdm), float(bdm),
           float(lf0.epf_pass0_sigma_scale),
           float(lf0.epf_pass2_sigma_scale),
           tuple(float(v) for v in cs))
    prog = _BATCH_PROGS.get(key)
    if prog is None:
        p0 = np.float32(lf0.epf_pass0_sigma_scale)
        p2 = np.float32(lf0.epf_pass2_sigma_scale)

        def one(qi, qfi, dci, xi, bi, gi, ispb, dmi, gki, sadi):
            import jax.numpy as jnp

            qi = qi.astype(jnp.int32)  # i16 staging widens on device
            # per-block sigma -> per-pixel on device (cheap; saves 64x
            # of the second-largest staging upload)
            ispi = jnp.repeat(jnp.repeat(ispb, 8, axis=0), 8,
                              axis=1)[:h, :w]
            return pl.decode_render_image(
                qi, qfi, dci, xi, bi, dmi, gi, xdm, bdm,
                gki if lf0.gab else None, ispi, sadi, cs,
                int(lf0.epf_iters), to_rgb="u8srgb",
                pass0_sigma_scale=p0, pass2_sigma_scale=p2,
                extra_tiles=(), dct8_mask=None, tile_shapes=(),
                size_passes=(), size_shapes=(), class_map=None,
                true_size=ts)

        prog = jax.jit(jax.vmap(one, in_axes=BATCH_IN_AXES))
        _BATCH_PROGS[key] = prog
    return prog, (qimg, qf, dc, ytox, ytob, igs, isp, dm0, gabk, sad)


def _qblocks_from_qimg(state):
    """Rebuild the per-block dict from the dense coefficient image so the
    host render path can take over (rare fallback)."""
    from ..vardct import ac_strategy as acs

    qimg = state.qimg
    for s in np.unique(state.strategy[state.is_origin]):
        s = int(s)
        cx, cy = acs.COVERED_X[s], acs.COVERED_Y[s]
        pos = np.argwhere(state.is_origin & (state.strategy == s))
        n = len(pos)
        tiles = _gather_tiles(qimg, pos[:, 0], pos[:, 1], cy * 8, cx * 8, n)
        for i, (by, bx) in enumerate(pos):
            state.qblocks[(int(by), int(bx))] = tiles[i].astype(np.int64)


def _render_subsampled_device(state, fh, out):
    """Device render for chroma-subsampled YCbCr frames (the JPEG
    recompression decode path): dequant + IDCT8 + box chroma upsampling
    + Gaborish/EPF + BT.601 + u8 write as one jitted program
    (ops/pipeline.py decode_render_subsampled). Returns True when final
    pixels were produced in out['u8']; False when the stream is outside
    the program's scope (decided before any device work) -> host
    render. Device failures propagate."""
    fd = state.fd
    if out is None or not out.get("want_u8", False):
        return False
    if state.patches is not None or state.splines is not None \
            or state.noise_lut is not None:
        return False
    if fh.upsampling != 1 \
            or fh.nonserialized_metadata.m.num_extra_channels:
        return False
    qb = getattr(state, "qblocks_sub", None)
    is444 = qb is None
    if is444:
        # 444 YCbCr rides the regular dense layout; all-DCT8 only
        from ..vardct import ac_strategy as acs

        if getattr(state, "qimg", None) is None:
            return False
        strategies = np.unique(state.strategy[state.is_origin])
        if not all(int(s) == acs.DCT for s in strategies):
            return False
        # the dense host path applies CfL and the x/b qm multipliers;
        # this lean YCbCr program assumes they are neutral
        if np.any(state.ytox_map) or np.any(state.ytob_map) \
                or state.x_dm_mult != 1.0 or state.b_dm_mult != 1.0 \
                or state.base_x != 0.0 or state.base_b != 0.0:
            return False
    elif getattr(state, "dc_sub", None) is None:
        return False
    from ..vardct.subsampled import _shifts

    hs, vs = _shifts(fh) if not is444 else ([0, 0, 0], [0, 0, 0])
    inv_gs = state.quantizer.inv_global_scale
    qs, dcs, scaled = [], [], []
    for c in range(3):
        nby = (fd.ysize_blocks + (1 << vs[c]) - 1) >> vs[c]
        nbx = (fd.xsize_blocks + (1 << hs[c]) - 1) >> hs[c]
        if is444:
            qs.append(state.qimg[c])
            dcs.append(np.asarray(state.dc[c], dtype=np.float32))
        else:
            plane5 = np.zeros((nby, 8, nbx, 8), dtype=np.int32)
            d = qb[c]
            if d:
                keys = np.array(list(d.keys()), dtype=np.int64)
                vals = np.stack([np.asarray(v) for v in
                                 d.values()]).astype(np.int32)
                plane5[keys[:, 0], :, keys[:, 1], :] = \
                    vals.reshape(-1, 8, 8)
            qs.append(plane5.reshape(nby * 8, nbx * 8))
            dcs.append(np.asarray(state.dc_sub[c],
                                  dtype=np.float32)[:nby, :nbx])
        qf = state.raw_quant_field[::1 << vs[c],
                                   ::1 << hs[c]][:nby, :nbx]
        scaled.append((inv_gs / qf).astype(np.float32))
    lf = fh.loop_filter
    h, w = fd.ysize_blocks * 8, fd.xsize_blocks * 8
    gab_kernels = np.zeros((3, 3, 3), dtype=np.float32)
    if lf.gab:
        from ..render.pipeline import gaborish_kernel

        gab_kernels = np.stack([
            gaborish_kernel(getattr(lf, f"gab_{ch}_weight1"),
                            getattr(lf, f"gab_{ch}_weight2"))
            for ch in "xyb"]).astype(np.float32)
    if lf.epf_iters > 0:
        from ..render.pipeline import _sad_mul_map, compute_sigma

        inv_sigma_b = compute_sigma(
            lf, state.quantizer.global_scale_float,
            state.raw_quant_field, state.epf_sharpness)
        inv_sigma_px = np.repeat(np.repeat(
            inv_sigma_b.astype(np.float32), 8, 0), 8, 1)[:h, :w]
        sad_mul = _sad_mul_map(h, w, lf.epf_border_sad_mul).astype(
            np.float32)
    else:
        inv_sigma_px = np.zeros((h, w), dtype=np.float32)
        sad_mul = np.ones((h, w), dtype=np.float32)
    dec_sub = _jitted_sub()
    result = dec_sub(
        tuple(qs), tuple(dcs), tuple(scaled),
        np.stack([state.matrices.dequant_matrix(0, c).reshape(8, 8)
                  for c in range(3)]).astype(np.float32),
        gab_kernels, inv_sigma_px, sad_mul,
        tuple(np.float32(v) for v in lf.epf_channel_scale),
        tuple((int(hs[c]), int(vs[c])) for c in range(3)),
        epf_iters=int(lf.epf_iters), gab=bool(lf.gab),
        pass0_scale=np.float32(lf.epf_pass0_sigma_scale),
        pass2_scale=np.float32(lf.epf_pass2_sigma_scale),
        to_u8=True,
        true_size=(fd.ysize, fd.xsize)
        if (fd.ysize, fd.xsize) != (h, w) else None)
    out["u8"] = np.asarray(result)
    out["path"] = "device:u8-ycbcr"
    state.device_output_done = True
    return True


def make_device_render(fh, out=None):
    """render_fn for decode_vardct_frame: dequant + all-strategy inverse
    transforms + Gaborish + EPF as one jitted XLA program. Subsampled
    (YCbCr 420/422) and pathological streams fall back to the host —
    LOUDLY: the fallback reason is logged and recorded in out["path"]
    so callers/tests can assert which path rendered."""
    import logging

    log = logging.getLogger("libjxl_tpu.device")
    _, _, _, _, dec_image = _jitted()

    def host_fallback(state, reason):
        if out is not None:
            out["path"] = f"host:{reason}"
        log.warning("device render fell back to host: %s", reason)
        if getattr(state, "qimg", None) is not None \
                and not state.qblocks:
            _qblocks_from_qimg(state)
        from ..vardct.frame import render_groups

        render_groups(state)

    def render_device(state):
        fd = state.fd
        if getattr(state, "qblocks_sub", None) is not None \
                or list(fh.chroma_subsampling.channel_mode) != [0, 0, 0]:
            if _render_subsampled_device(state, fh, out):
                state.restoration_done = True
                return
            if out is not None:
                out["path"] = "host:chroma-subsampled"
            log.warning("device render fell back to host: "
                        "chroma-subsampled stream")
            from ..vardct.subsampled import render_groups_sub

            render_groups_sub(state)
            return
        if getattr(state, "qimg", None) is None:
            # the bulk entropy path didn't run (small image / lz77 /
            # prefix streams): assemble the dense image from qblocks
            from ..vardct import ac_strategy as acs

            fdh, fdw = fd.ysize_blocks * 8, fd.xsize_blocks * 8
            state.qimg = np.zeros((3, fdh, fdw), dtype=np.int32)
            q5 = state.qimg.reshape(3, fd.ysize_blocks, 8,
                                    fd.xsize_blocks, 8)
            for (by, bx), blk in state.qblocks.items():
                s = int(state.strategy[by, bx])
                cx, cy = acs.COVERED_X[s], acs.COVERED_Y[s]
                state.qimg[:, by * 8:(by + cy) * 8,
                           bx * 8:(bx + cx) * 8] = \
                    np.asarray(blk).reshape(3, cy * 8, cx * 8)
        from ..io.frame_header import CT_XYB, CT_YCBCR

        if fh.color_transform == CT_YCBCR:
            # 444 YCbCr (JPEG transcode without chroma subsampling)
            if _render_subsampled_device(state, fh, out):
                state.restoration_done = True
                return
            host_fallback(state, "YCbCr 444 outside the lean device "
                          "program")
            return
        if fh.color_transform != CT_XYB or \
                getattr(state, "color_factor", 84) != 84 or \
                getattr(state, "base_x", 0.0) != 0.0 or \
                getattr(state, "base_b", 1.0) != 1.0:
            host_fallback(state, "non-XYB or custom color correlation")
            return
        prep = _prepare_batches(state, state.qimg)
        if prep is None:
            host_fallback(state, "unaligned/odd-size transform layout")
            return
        extra, shapes, mask_px, size_passes, size_shapes, class_map = prep
        nby, nbx = fd.ysize_blocks, fd.xsize_blocks
        h, w = nby * 8, nbx * 8
        qimg = state.qimg
        dm = np.stack([state.matrices.dequant_matrix(0, c)
                       for c in range(3)]).astype(np.float32)
        lf = fh.loop_filter
        gab_kernels = np.zeros((3, 3, 3), dtype=np.float32)
        if lf.gab:
            from ..render.pipeline import gaborish_kernel

            gab_kernels = np.stack([
                gaborish_kernel(getattr(lf, f"gab_{ch}_weight1"),
                                getattr(lf, f"gab_{ch}_weight2"))
                for ch in "xyb"]).astype(np.float32)
        if lf.epf_iters > 0:
            from ..render.pipeline import _sad_mul_map, compute_sigma

            inv_sigma_b = compute_sigma(
                lf, state.quantizer.global_scale_float,
                state.raw_quant_field, state.epf_sharpness)
            inv_sigma_px = np.repeat(np.repeat(
                inv_sigma_b.astype(np.float32), 8, 0), 8, 1)[:h, :w]
            sad_mul = _sad_mul_map(h, w, lf.epf_border_sad_mul).astype(
                np.float32)
        else:
            inv_sigma_px = np.zeros((h, w), dtype=np.float32)
            sad_mul = np.ones((h, w), dtype=np.float32)
        # with no post-render features the whole write stage (XYB->sRGB
        # u8) stays on device and the host never touches pixel floats
        direct_u8 = (out is not None and out.get("want_u8", True)
                     and state.patches is None
                     and state.splines is None and state.noise_lut is None
                     and fh.upsampling == 1
                     and fh.nonserialized_metadata.m.num_extra_channels
                     == 0
                     and fd.ysize == h and fd.xsize == w)
        result = dec_image(
            qimg, state.raw_quant_field.astype(np.int32),
            state.dc.astype(np.float32),
            state.ytox_map.astype(np.int32),
            state.ytob_map.astype(np.int32), dm,
            np.float32(state.quantizer.inv_global_scale),
            np.float32(state.x_dm_mult), np.float32(state.b_dm_mult),
            gab_kernels, inv_sigma_px, sad_mul,
            tuple(np.float32(v) for v in lf.epf_channel_scale),
            int(lf.epf_iters),
            np.float32(lf.epf_pass0_sigma_scale),
            np.float32(lf.epf_pass2_sigma_scale),
            tuple(extra), mask_px, tuple(size_passes), class_map,
            tile_shapes=shapes, gab=bool(lf.gab),
            to_rgb="u8srgb" if direct_u8 else False,
            size_shapes=size_shapes,
            true_size=(fd.ysize, fd.xsize)
            if (fd.ysize, fd.xsize) != (h, w) else None)
        if direct_u8:
            out["u8"] = np.asarray(result)
            out["path"] = "device:u8"
            state.device_output_done = True
        else:
            state.xyb = np.asarray(result, dtype=np.float64)
            if out is not None:
                out["path"] = "device:xyb"
        state.restoration_done = True

    return render_device


def accelerator_available() -> bool:
    """True when JAX's default backend is a GPU: the decode and encode
    APIs then run their pixel programs on the card by default. On a
    CPU-only install the host codec serves (XLA-on-host compile times
    dwarf the NumPy render for one image)."""
    import jax

    return jax.default_backend() == "gpu"


# below this pixel count a one-shot CLI invocation is faster on host:
# the first call of the render/encode program for a new shape pays its
# XLA compile (seconds), which only amortizes over large images or
# repeated same-shape calls (servers, benchmarks)
DEVICE_AUTO_MIN_PIXELS = 1 << 20


def device_worthwhile(pixels: int) -> bool:
    import os

    thr = int(os.environ.get("LIBJXL_TPU_DEVICE_MIN_PIXELS",
                             DEVICE_AUTO_MIN_PIXELS))
    # pixel gate first: small one-shot images never pay backend init
    return pixels >= thr and accelerator_available()
