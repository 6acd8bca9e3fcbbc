"""Device EPF chain (ops/pipeline.epf_jax, the XLA stencil every device
render program runs) against the host reference
(render/pipeline.apply_epf) at each iteration count."""

import numpy as np
import pytest

from libjxl_tpu.io.frame_header import LoopFilter
from libjxl_tpu.ops import pipeline as pl
from libjxl_tpu.render.pipeline import _sad_mul_map, apply_epf


@pytest.mark.parametrize("epf_iters", [1, 2, 3])
def test_epf_jax_matches_host(epf_iters):
    rng = np.random.default_rng(epf_iters)
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w]
    xyb = np.stack([0.02 * np.sin(xx / 5 + c) + 0.4 * (c == 1)
                    for c in range(3)]) + rng.normal(0, 0.002, (3, h, w))
    lf = LoopFilter()
    lf.epf_iters = epf_iters
    # per-block 1/sigma (negative), a few blocks below the skip bound
    inv_sigma = -rng.uniform(0.05, 0.5, (h // 8, w // 8))
    inv_sigma[0, 0] = -10.0
    ref = apply_epf(xyb.copy(), lf, inv_sigma)
    inv_px = np.repeat(np.repeat(inv_sigma, 8, 0), 8, 1).astype(np.float32)
    got = pl.epf_jax(
        xyb.astype(np.float32), inv_px,
        _sad_mul_map(h, w, lf.epf_border_sad_mul),
        tuple(np.float32(v) for v in lf.epf_channel_scale), epf_iters,
        np.float32(lf.epf_pass0_sigma_scale),
        np.float32(lf.epf_pass2_sigma_scale))
    assert np.abs(np.asarray(got) - ref).max() < 2e-5
    # the filter did something: the check is not vacuous
    assert np.abs(ref - xyb).max() > 1e-3
