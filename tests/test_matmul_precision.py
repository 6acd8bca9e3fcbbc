"""Every matrix product and convolution in the device programs names
Precision.HIGHEST.

On a GPU, XLA may run a float32 dot_general or convolution in TF32
(about three decimal digits) unless the precision is named; the
conformance bounds (ISO 18181-3) do not survive that. Each case traces
one device program the codec runs and walks its jaxpr, sub-programs
included (pjit, shard_map, control flow).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from libjxl_tpu.api import codestream, tpu_codec
from libjxl_tpu.ops import pipeline as pl

HIGHEST = jax.lax.Precision.HIGHEST
PRODUCTS = ("dot_general", "conv_general_dilated")


def _subjaxprs(params):
    for v in params.values():
        for item in (v if isinstance(v, (list, tuple)) else (v,)):
            if hasattr(item, "eqns"):
                yield item
            elif hasattr(item, "jaxpr") and hasattr(item, "consts"):
                yield item.jaxpr


def _products(jaxpr):
    """(primitive name, precision) of every product, recursively."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in PRODUCTS:
            yield eqn.primitive.name, eqn.params.get("precision")
        for sub in _subjaxprs(eqn.params):
            yield from _products(sub)


def _is_highest(p):
    if p is None:
        return False
    return all(x == HIGHEST for x in (p if isinstance(p, tuple) else (p,)))


def _image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 80 * np.sin(xx / 9 + c) * np.cos(yy / 13 - c)
                    for c in range(3)], -1) + rng.normal(0, 6, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


class _Recorder:
    """Wraps a jitted program and keeps the arguments of its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *a, **k):
        self.calls.append((a, k))
        return self.fn(*a, **k)


def _traced_call(rec):
    assert rec.calls, "program was not called"
    a, k = rec.calls[0]
    # everything closed over: static positional arguments stay concrete
    return jax.make_jaxpr(lambda: rec.fn(*a, **k))()


def _encode_step(monkeypatch):
    progs = list(tpu_codec._jitted())
    rec = progs[0] = _Recorder(progs[0])
    monkeypatch.setattr(tpu_codec, "_jitted", lambda: tuple(progs))
    tpu_codec.encode_lossy_tpu(_image(64, 64), distance=1.0)
    return _traced_call(rec)


def _single_render(monkeypatch):
    # an e7 stream: merged DCT sizes and 8x8 specials on the dense grid
    data = codestream.encode_lossy(_image(128, 128, 1), distance=1.0,
                                   effort=7, device=False)
    progs = list(tpu_codec._jitted())
    rec = progs[4] = _Recorder(progs[4])
    monkeypatch.setattr(tpu_codec, "_jitted", lambda: tuple(progs))
    info = {}
    codestream.decode(data, device=True, decode_info=info)
    assert info["path"].startswith("device"), info
    return _traced_call(rec)


def _subsampled_render(monkeypatch):
    from libjxl_tpu.io.frame_header import FrameHeader
    from libjxl_tpu.io.bits import BitReader
    from libjxl_tpu.vardct.frame import decode_vardct_frame

    rec = _Recorder(tpu_codec._jitted_sub())
    monkeypatch.setattr(tpu_codec, "_jitted_sub", lambda: rec)
    data = _ycbcr420_stream()
    r = BitReader(data)
    fh = FrameHeader(codestream.parse_codestream_header(r))
    fh.read(r)
    out = {"want_u8": True}
    decode_vardct_frame(r, fh, render_fn=tpu_codec.make_device_render(
        fh, out), want_qimg=True)
    assert out["path"] == "device:u8-ycbcr", out.get("path")
    return _traced_call(rec)


def _ycbcr420_stream():
    import io

    Image = pytest.importorskip("PIL.Image")
    from libjxl_tpu.io.container import extract_codestream
    from libjxl_tpu.jpeg.recompress import recompress_jpeg_vardct

    buf = io.BytesIO()
    Image.fromarray(_image(64, 80, 2)).save(buf, "JPEG", quality=85,
                                            subsampling="4:2:0")
    return extract_codestream(recompress_jpeg_vardct(buf.getvalue()))


def _batched_render(monkeypatch):
    streams = [codestream.encode_lossy(_image(64, 64, s), distance=1.0,
                                       effort=3, device=False)
               for s in range(2)]
    prog, args = tpu_codec.prepare_tpu_batch(streams)
    return jax.make_jaxpr(prog)(*args)


def _butteraugli(monkeypatch):
    from libjxl_tpu.metrics.butteraugli_jax import butteraugli_diffmap_jax

    a = _image(64, 64).astype(np.float32).transpose(2, 0, 1) / 255.0
    return jax.make_jaxpr(butteraugli_diffmap_jax)(a, a * 0.98)


def _refine_trial(monkeypatch):
    from libjxl_tpu.ops.dct import inv_matrix
    from libjxl_tpu.vardct.heuristics import _trial_render

    f32 = np.float32
    args = (np.ones((3, 8, 8, 8, 8), f32), np.zeros((3, 8, 8), f32),
            np.full((8, 8), 20, f32), np.ones((3, 8, 8), f32),
            np.ones((3, 8, 8), f32), f32(0.01), inv_matrix(8).astype(f32),
            np.full((3, 3, 3), 1 / 9, f32), np.full((64, 64), -1, f32),
            np.ones((64, 64), f32), (f32(40), f32(5), f32(3.5)), f32(0.9),
            f32(6.5))
    return jax.make_jaxpr(functools.partial(
        _trial_render, gab_on=True, epf_iters=3))(*args)


def _tile_cost(monkeypatch):
    from libjxl_tpu.ops.dct import fwd_matrix, inv_matrix
    from libjxl_tpu.vardct.frame import _tile_cost_program

    f32 = np.float32
    rows, cols = 16, 32
    args = (np.ones((3, 64, 64), f32), np.ones((3, rows, cols), f32),
            np.ones((3, rows, cols), f32), np.ones((4, 2), f32), f32(0.01),
            fwd_matrix(rows).astype(f32), fwd_matrix(cols).astype(f32),
            inv_matrix(rows).astype(f32), inv_matrix(cols).astype(f32),
            np.ones(3, f32), f32(320.0))
    return jax.make_jaxpr(functools.partial(
        _tile_cost_program, rows=rows, cols=cols, tby=4, tbx=2))(*args)


def _rows_mesh():
    return Mesh(np.array(jax.devices()[:2]), ("rows",))


def _sharded_stream_decode(monkeypatch):
    from libjxl_tpu.io.frame_header import LoopFilter
    from libjxl_tpu.parallel.sharding import build_sharded_decode_stream

    lf = LoopFilter()
    fn = build_sharded_decode_stream(
        _rows_mesh(), lf, 0.01, 1.0, 1.0,
        np.full((3, 3, 3), 1 / 9, np.float32), (40.0, 5.0, 3.5))
    h = w = 128
    args = (np.zeros((3, h, w), np.int32), np.ones((16, 16), np.int32),
            np.zeros((3, 16, 16), np.float32), np.zeros((2, 2), np.int32),
            np.zeros((2, 2), np.int32), np.ones((3, 8, 8), np.float32),
            np.full((h, w), -1, np.float32), np.ones((h, w), np.float32))
    return jax.make_jaxpr(fn)(*args)


def _sharded_gaborish_conv(monkeypatch):
    from libjxl_tpu.parallel.sharding import build_sharded_decode, make_mesh

    mesh = make_mesh(jax.devices()[:2], batch=1)
    fn = build_sharded_decode(mesh, apply_gab=True)
    nby, nbx = 4, 2
    args = (np.zeros((1, 3, nby, nbx, 8, 8), np.int32),
            np.ones((1, nby, nbx), np.int32),
            np.zeros((1, 3, nby, nbx), np.float32),
            np.zeros((1, nby, 1), np.int32), np.zeros((1, nby, 1), np.int32),
            np.ones((3, 8, 8), np.float32))
    jaxpr = jax.make_jaxpr(fn)(*args)
    assert "conv_general_dilated" in {n for n, _ in _products(jaxpr.jaxpr)}
    return jaxpr


def _sharded_chunk_encode(monkeypatch):
    from libjxl_tpu.parallel.sharding import make_sharded_chunk_step

    fn = make_sharded_chunk_step(_rows_mesh())
    f32 = np.float32
    args = (np.zeros((3, 128, 64), f32), np.ones((3, 8, 8), f32),
            np.ones((3, 8, 8), f32), f32(0.01), f32(20), f32(1), f32(1),
            np.full((16, 8), 20, np.int32))
    return jax.make_jaxpr(fn)(*args)


PROGRAMS = {
    "encode_step": _encode_step,
    "single_render": _single_render,
    "subsampled_render": _subsampled_render,
    "batched_render": _batched_render,
    "butteraugli_diffmap": _butteraugli,
    "refine_trial": _refine_trial,
    "tile_cost": _tile_cost,
    "sharded_stream_decode": _sharded_stream_decode,
    "sharded_gaborish_conv": _sharded_gaborish_conv,
    "sharded_chunk_encode": _sharded_chunk_encode,
}


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_products_use_highest_precision(program, monkeypatch):
    closed = PROGRAMS[program](monkeypatch)
    found = list(_products(closed.jaxpr))
    assert found, f"{program}: no matrix product traced"
    loose = [(n, p) for n, p in found if not _is_highest(p)]
    assert not loose, f"{program}: products without HIGHEST: {loose}"


def test_walker_flags_a_default_precision_product():
    """The check itself: a product that names no precision is caught."""
    jaxpr = jax.make_jaxpr(lambda a: jnp.einsum("ij,jk->ik", a, a))(
        np.ones((4, 4), np.float32))
    found = list(_products(jaxpr.jaxpr))
    assert found and not all(_is_highest(p) for _, p in found)
    assert pl.idct8_blocks  # the pipeline module imports cleanly
