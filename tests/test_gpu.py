"""Checks only the card can make. Marked `gpu`: they skip on the CPU
test mesh, and `python chip_smoke.py` runs them on the GPU."""

import numpy as np
import pytest


@pytest.mark.gpu
def test_large_images_default_to_the_device(gpu):
    from libjxl_tpu.api import tpu_codec

    assert tpu_codec.accelerator_available()
    assert tpu_codec.device_worthwhile(tpu_codec.DEVICE_AUTO_MIN_PIXELS)
    assert not tpu_codec.device_worthwhile(
        tpu_codec.DEVICE_AUTO_MIN_PIXELS - 1)


@pytest.mark.gpu
def test_dct_products_run_in_full_float32(gpu):
    """TF32 keeps ~10 mantissa bits (error ~1e-3 on these blocks);
    Precision.HIGHEST must give float32 accuracy on the card."""
    from libjxl_tpu.ops import pipeline as pl
    from libjxl_tpu.ops.dct import inv_matrix

    rng = np.random.default_rng(0)
    blocks = rng.normal(0, 1, (3, 64, 64, 8, 8)).astype(np.float32)
    got = np.asarray(pl.idct8_blocks(blocks))
    i8 = inv_matrix(8)
    ref = np.einsum("ru,...vu,cv->...rc", i8, blocks.astype(np.float64), i8)
    assert np.abs(got - ref).max() < 2e-5


@pytest.mark.gpu
def test_default_decode_renders_on_device(gpu):
    from libjxl_tpu.api import codestream

    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:1024, 0:1024]
    img = np.clip(np.stack([120 + 60 * np.sin(xx / 40 + c)
                            + 40 * np.cos(yy / 55) for c in range(3)], -1)
                  + rng.normal(0, 4, (1024, 1024, 3)), 0, 255
                  ).astype(np.uint8)
    data = codestream.encode_lossy(img, distance=1.0, effort=3)
    info = {}
    dev, _ = codestream.decode(data, decode_info=info)
    assert info["path"] == "device:u8", info
    host, _ = codestream.decode(data, device=False)
    d = np.abs(dev.astype(int) - host[:, :, :3].astype(int))
    assert d.max() <= 1 and (d != 0).mean() < 1e-3
