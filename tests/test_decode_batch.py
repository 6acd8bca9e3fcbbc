"""Batched device decode (api/tpu_codec.decode_tpu_batch): N distinct
same-geometry streams rendered by one vmapped dispatch — the device
serving path the benchmark times."""

import numpy as np
import pytest

from libjxl_tpu.api import codestream
from libjxl_tpu.api.tpu_codec import decode_tpu_batch
from libjxl_tpu.base.status import JXLError


def _streams(n, h=320, w=240, seed=9):
    rng = np.random.default_rng(seed)
    out, refs = [], []
    for i in range(n):
        img = np.clip(rng.normal(110 + 15 * i, 35, (h, w, 3)), 0,
                      255).astype(np.uint8)
        s = codestream.encode_lossy(img, distance=1.0, effort=3,
                                    device=False)
        out.append(s)
        refs.append(codestream.decode(s, device=False)[0])
    return out, refs


def test_batch_matches_individual_decodes():
    streams, refs = _streams(3)
    outs = decode_tpu_batch(streams)
    assert len(outs) == 3
    for ref, out in zip(refs, outs):
        assert out.shape == ref[:, :, :3].shape
        assert np.abs(ref[:, :, :3].astype(int)
                      - out.astype(int)).max() <= 1


def test_batch_rejects_mixed_geometry():
    a, _ = _streams(1)
    b, _ = _streams(1, h=128, w=128)
    with pytest.raises(JXLError):
        decode_tpu_batch(a + b)


def test_public_decode_batch_falls_back():
    """codestream.decode_batch returns correct pixels even when device
    batching is unavailable (heterogeneous input)."""
    a, ra = _streams(1)
    b, rb = _streams(1, h=128, w=128)
    outs = codestream.decode_batch(a + b)
    assert np.abs(outs[0][:, :, :3].astype(int)
                  - ra[0][:, :, :3].astype(int)).max() <= 1
    assert np.abs(outs[1][:, :, :3].astype(int)
                  - rb[0][:, :, :3].astype(int)).max() <= 1


def test_pipelined_matches_batch():
    """decode_tpu_pipelined (entropy/render overlap, uneven tail batch)
    produces exactly the pixels of the one-dispatch batch path."""
    from libjxl_tpu.api.tpu_codec import decode_tpu_pipelined

    streams, refs = _streams(5, h=256, w=192)
    base = decode_tpu_batch(streams)
    piped = decode_tpu_pipelined(streams, batch_size=2)
    assert len(piped) == 5
    for b, p, ref in zip(base, piped, refs):
        assert np.array_equal(b, p)
        assert np.abs(ref[:, :, :3].astype(int)
                      - p.astype(int)).max() <= 1


def test_pipelined_rejects_out_of_scope_batch():
    a, _ = _streams(2)
    b, _ = _streams(1, h=128, w=128)
    from libjxl_tpu.api.tpu_codec import decode_tpu_pipelined

    with pytest.raises(JXLError):
        # first batch [a0, a1, b0] mixes geometry -> loud failure
        decode_tpu_pipelined(a + b, batch_size=3)
    # per-batch homogeneity is enough: mixed geometry ACROSS batches
    # decodes fine (each batch compiles its own program)
    outs = decode_tpu_pipelined(a + b, batch_size=2)
    assert outs[0].shape != outs[2].shape


def test_sharded_batch_decode_on_mesh():
    """Data-parallel serving decode over the 8-device virtual mesh."""
    import jax
    from jax.sharding import Mesh

    from libjxl_tpu.api.tpu_codec import decode_tpu_batch_sharded

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    streams, refs = _streams(8, h=256, w=192)
    mesh = Mesh(np.array(devs[:8]), ("batch",))
    outs = decode_tpu_batch_sharded(streams, mesh=mesh)
    for ref, out in zip(refs, outs):
        assert np.abs(ref[:, :, :3].astype(int)
                      - out.astype(int)).max() <= 1
    # non-divisible batch raises
    with pytest.raises(JXLError):
        decode_tpu_batch_sharded(streams[:3], mesh=mesh)


def test_decode_batch_buckets_mixed_geometry():
    """Mixed fleets bucket by geometry: each same-size group batches on
    device, singletons decode per-stream — order preserved."""
    from libjxl_tpu.api.codestream import decode_batch

    a, ra = _streams(2)
    b, rb = _streams(2, h=128, w=128)
    c, rc = _streams(1, h=64, w=96)
    mixed = [a[0], b[0], c[0], a[1], b[1]]
    refs = [ra[0], rb[0], rc[0], ra[1], rb[1]]
    outs = decode_batch(mixed)
    assert [o.shape[:2] for o in outs] == [r.shape[:2] for r in refs]
    for o, r in zip(outs, refs):
        assert np.abs(o.astype(int)
                      - r[:, :, :3].astype(int)).max() <= 1
