"""Device failures propagate: nothing on the device path swallows an
exception and silently serves the host codec instead. (Refusals by
format scope, decided before any device work, are tested elsewhere.)"""

import io

import numpy as np
import pytest

from libjxl_tpu.api import codestream, tpu_codec
from libjxl_tpu.vardct import frame as vf
from libjxl_tpu.vardct import heuristics


def _image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 80 * np.sin(xx / 9 + c) * np.cos(yy / 13 - c)
                    for c in range(3)], -1) + rng.normal(0, 6, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _boom(*a, **k):
    raise RuntimeError("forced device failure")


def test_refinement_failure_propagates(monkeypatch):
    monkeypatch.setattr(heuristics, "_trial_jit", lambda: _boom)
    with pytest.raises(RuntimeError, match="forced device failure"):
        codestream.encode_lossy(_image(64, 64), distance=1.0, effort=7,
                                device=True)


def test_tile_cost_failure_propagates(monkeypatch):
    monkeypatch.setattr(vf, "_tile_cost_jit", lambda: _boom)
    with pytest.raises(RuntimeError, match="forced device failure"):
        codestream.encode_lossy(_image(64, 64), distance=1.0, effort=7,
                                device=True)


def test_host_encode_leaves_the_device_alone(monkeypatch):
    """device=False keeps the e7 heuristics on the host even where JAX
    has a GPU."""
    monkeypatch.setattr(tpu_codec, "accelerator_available", lambda: True)
    monkeypatch.setattr(heuristics, "_trial_jit", lambda: _boom)
    monkeypatch.setattr(vf, "_tile_cost_jit", lambda: _boom)
    data = codestream.encode_lossy(_image(64, 64), distance=1.0, effort=7,
                                   device=False)
    assert codestream.decode(data, device=False)[0].shape == (64, 64, 3)


def test_subsampled_render_failure_propagates(monkeypatch):
    Image = pytest.importorskip("PIL.Image")
    from libjxl_tpu.io.container import extract_codestream
    from libjxl_tpu.jpeg.recompress import recompress_jpeg_vardct

    buf = io.BytesIO()
    Image.fromarray(_image(64, 80, 2)).save(buf, "JPEG", quality=85,
                                            subsampling="4:2:0")
    stream = extract_codestream(recompress_jpeg_vardct(buf.getvalue()))
    monkeypatch.setattr(tpu_codec, "_jitted_sub", lambda: _boom)
    with pytest.raises(RuntimeError, match="forced device failure"):
        codestream.decode(stream, device=True)
