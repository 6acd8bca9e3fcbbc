"""Oracle conformance corpus: reference-encoded streams, pinned refs.

Each case in tests/data/conformance/ was encoded by the REFERENCE
implementation (system libjxl; tools/gen_conformance_corpus.py) and
carries the reference decoder's own pixels as .npy ground truth. This
replays the corpus with OUR decoder on every test run — no libjxl
needed at test time — closing the self-referential-conformance gap:
the bounds mirror the reference's ISO 18181-3 harness
(tools/conformance/conformance.py:26-45): bit-exact for lossless,
RMSE + peak-error bounds for lossy, byte-exact JPEG reconstruction.
"""

import json
import os

import numpy as np
import pytest

from libjxl_tpu.api import codestream

CORPUS = os.path.join(os.path.dirname(__file__), "data", "conformance")

if not os.path.exists(os.path.join(CORPUS, "manifest.json")):
    pytest.skip("conformance corpus not generated", allow_module_level=True)

with open(os.path.join(CORPUS, "manifest.json")) as f:
    MANIFEST = json.load(f)

PIXEL_CASES = [c for c in MANIFEST["cases"]
               if c["kind"] in ("lossless", "lossy")]


def _check_case(case, device=None):
    with open(os.path.join(CORPUS, case["name"] + ".jxl"), "rb") as f:
        data = f.read()
    ref = np.load(os.path.join(CORPUS, case["name"] + ".npy"))
    ours, _ = codestream.decode(data, device=device)
    nc = min(ours.shape[2], ref.shape[2])
    assert ours.shape[:2] == ref.shape[:2]
    if case["kind"] == "lossless":
        assert np.array_equal(ours[:, :, :nc], ref[:, :, :nc]), case["name"]
        return
    d = (ours[:, :, :nc].astype(np.float64)
         - ref[:, :, :nc].astype(np.float64))
    rmse = float(np.sqrt((d ** 2).mean()))
    peak = int(np.abs(d).max())
    # conformance bounds (conformance.py:26-45 stance): decoders of the
    # same stream may differ only by float-pipeline rounding; noise
    # streams get a looser RMSE (every pixel carries synthesized dither
    # whose final rounding may differ by 1), and high-distance streams
    # scale the bound with the quantization step (one DC step at d6 is
    # ~8 u8 levels, so half-step fp differences span several levels)
    dist = float(case.get("encode_args", {}).get("distance", 1.0))
    if dist >= 4.0:
        limit, peak_limit = 0.5 * dist, int(2 * dist)
    elif "noise" in case["name"]:
        limit, peak_limit = 0.75, 2
    else:
        limit, peak_limit = 0.2, 2
    assert rmse < limit, (case["name"], rmse, "gen", case["gen_rmse"])
    assert peak <= peak_limit, (case["name"], peak, "gen",
                                case["gen_peak"])


@pytest.mark.parametrize("case", PIXEL_CASES,
                         ids=[c["name"] for c in PIXEL_CASES])
def test_conformance_case(case):
    _check_case(case)


@pytest.mark.gpu
@pytest.mark.parametrize("case", PIXEL_CASES,
                         ids=[c["name"] for c in PIXEL_CASES])
def test_conformance_case_on_device(gpu, case):
    """The same bounds with every stream asked onto the device path
    (streams outside its format scope are refused to the host)."""
    _check_case(case, device=True)


def test_jpeg_reconstruction_case():
    jc = [c for c in MANIFEST["cases"]
          if c["kind"] == "jpeg_reconstruction"]
    if not jc:
        pytest.skip("no jpeg case in corpus")
    with open(os.path.join(CORPUS, "jpeg_recon.jxl"), "rb") as f:
        data = f.read()
    with open(os.path.join(CORPUS, "jpeg_recon.jpg"), "rb") as f:
        jpg = f.read()
    from libjxl_tpu.jpeg.recompress import reconstruct_jpeg

    assert reconstruct_jpeg(data) == jpg


def test_jpeg_recon_pixel_decode():
    """The oracle's JPEG-recompressed container must also PIXEL-decode
    (YCbCr VarDCT transcode path), matching an independent JPEG decode
    of the original file within IDCT rounding."""
    jc = [c for c in MANIFEST["cases"]
          if c["kind"] == "jpeg_reconstruction"]
    if not jc:
        pytest.skip("no jpeg case in corpus")
    with open(os.path.join(CORPUS, "jpeg_recon.jxl"), "rb") as f:
        data = f.read()
    ours, _ = codestream.decode(data)
    try:
        from PIL import Image
    except ImportError:
        pytest.skip("no PIL")
    import io as _io

    with open(os.path.join(CORPUS, "jpeg_recon.jpg"), "rb") as f:
        ref = np.asarray(Image.open(_io.BytesIO(f.read())).convert("RGB"))
    assert ours.shape[:2] == ref.shape[:2]
    d = np.abs(ours[:, :, :3].astype(int) - ref.astype(int))
    # two independent JPEG decoders (ours via the VarDCT transcode,
    # PIL's libjpeg): differences are IDCT/upsampling rounding only
    assert d.mean() < 2.0 and d.max() <= 32, (d.mean(), d.max())


@pytest.mark.gpu
def test_jpeg_recon_renders_on_device(gpu):
    """The JPEG-recompressed stream takes the device YCbCr program and
    agrees with the host decoder within float32 rounding."""
    with open(os.path.join(CORPUS, "jpeg_recon.jxl"), "rb") as f:
        data = f.read()
    info = {}
    dev, _ = codestream.decode(data, device=True, decode_info=info)
    assert info["path"] == "device:u8-ycbcr", info
    host, _ = codestream.decode(data, device=False)
    d = np.abs(dev[:, :, :3].astype(int) - host[:, :, :3].astype(int))
    assert d.max() <= 1 and (d != 0).mean() < 1e-3, (d.max(),
                                                     (d != 0).mean())
