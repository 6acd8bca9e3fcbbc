"""GPU smoke test: the codec's encode and decode path on the card.

    python chip_smoke.py           # phases a-e on one GPU
    python chip_smoke.py --four    # the multi-card paths on four GPUs

Phases (one GPU), each checked against the host NumPy/C codec
(`device=False`) or the checked-in conformance corpus:

  a  encode_lossy of 32 distinct 2048x2048 images at d1/e3 (device
     encoder), one re-encoded on the host: stream size and PSNR agree;
  b  decode_batch of the 32 streams (pipelined batched render) against
     per-stream host decodes;
  c  decode of one d1/e3 and one d1/e7 2048x2048 stream through the
     single-stream device render (all 27 strategies) against the host;
  d  encode_lossy at d1/e7 2048x2048 (device tile costs, device
     Butteraugli refinement), and the device Butteraugli diffmap
     against the host model on a 512x512 pair;
  e  every stream of tests/data/conformance through decode on the
     device path, against the stored reference-decoder pixels (the
     `gpu`-marked cases of tests/test_conformance_oracle.py, run here
     with tests/test_gpu.py before the other phases).

`--four` runs only the paths that span cards: a 64 MP image decoded
strip-sharded over a 4-GPU ("rows",) mesh, bit-exact against the same
strip program on one card and within the device/host bound of the
whole-image render, and the batched render of 16 streams sharded over
4 cards, bit-exact against one card.

Earlier lines carry the card, versions and timings; the last line is
one JSON object. The script exits non-zero, printing no result, when
JAX finds no GPU or any phase misses its tolerance.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N = 2048
N_STREAMS = 32
REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def make_image(n, seed):
    """Seeded photo-like sRGB u8 image (smooth fields plus sensor noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    img = (120 + 60 * np.sin(xx * 0.003 + seed)
           + 50 * np.cos(yy * 0.002 + 1)
           + 20 * np.sin((xx + yy) * 0.01) + rng.normal(0, 5, (n, n)))
    rgb = np.stack([img, img * 0.9 + 10, img * 1.1 - 12], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def psnr(a, b):
    d = a[..., :3].astype(np.float64) - b[..., :3].astype(np.float64)
    return 10 * np.log10(255.0 ** 2 / max(float((d ** 2).mean()), 1e-12))


def check_pixels(name, got, ref):
    """The device/host bound of tests/test_tpu_codec.py: float32 device
    vs float64 host math may flip isolated u8 roundings."""
    assert got.shape[:2] == ref.shape[:2], (name, got.shape, ref.shape)
    d = np.abs(got[..., :3].astype(np.int16) - ref[..., :3].astype(np.int16))
    frac = float((d != 0).mean())
    assert d.max() <= 1 and frac < 1e-3, (name, int(d.max()), frac)
    return int(d.max()), frac


class Spy:
    """Counts calls (and failures) of a module function, so a phase can
    assert which path served it."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = self.failures = 0

    def __enter__(self):
        def wrapped(*a, **k):
            self.calls += 1
            try:
                return self.fn(*a, **k)
            except Exception:
                self.failures += 1
                raise

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def timed(fn, *a, **k):
    t0 = time.perf_counter()
    out = fn(*a, **k)
    return out, time.perf_counter() - t0


def strategies_used(data):
    """Set of AC strategies in a VarDCT stream (host entropy decode)."""
    from libjxl_tpu.api.codestream import parse_codestream_header
    from libjxl_tpu.io.bits import BitReader
    from libjxl_tpu.io.frame_header import FrameHeader
    from libjxl_tpu.vardct.frame import decode_vardct_frame

    r = BitReader(data)
    meta = parse_codestream_header(r)
    fh = FrameHeader(meta)
    fh.read(r)
    cap = {}

    def capture(state):
        cap["s"] = state
        state.restoration_done = True
        state.device_output_done = True

    decode_vardct_frame(r, fh, render_fn=capture, want_qimg=True)
    st = cap["s"]
    return {int(s) for s in np.unique(st.strategy[st.is_origin])}


# ------------------------------------------------------------------ phases
def phase_a(n, count, times):
    """Device encode of `count` distinct images; one host re-encode."""
    from libjxl_tpu.api import codestream, tpu_codec

    imgs = [make_image(n, seed=100 + i) for i in range(count)]
    streams, runs = [], []
    with Spy(tpu_codec, "encode_lossy_tpu") as spy:
        for img in imgs:
            s, t = timed(codestream.encode_lossy, img, distance=1.0,
                         effort=3)
            streams.append(s)
            runs.append(t)
    assert spy.calls == count and spy.failures == 0, \
        f"device encoder served {spy.calls - spy.failures}/{count}"
    times["a_cold_s"] = runs[0]
    times["a_warm_s"] = statistics.median(runs[1:]) if count > 1 else None
    assert len(set(streams)) == count, "streams must be distinct"
    host, t_host = timed(codestream.encode_lossy, imgs[0], distance=1.0,
                         effort=3, device=False)
    times["a_host_encode_s"] = t_host
    dev_px = codestream.decode(streams[0], device=False)[0]
    host_px = codestream.decode(host, device=False)[0]
    size_rel = abs(len(streams[0]) - len(host)) / len(host)
    p_dev, p_host = psnr(dev_px, imgs[0]), psnr(host_px, imgs[0])
    log(f"phase a: {count} x {n}^2 d1/e3 device encodes, cold "
        f"{times['a_cold_s']:.3f}s warm median {times['a_warm_s']}s; "
        f"host encode {t_host:.3f}s; size dev {len(streams[0])} host "
        f"{len(host)} (rel {size_rel:.5f}); PSNR dev {p_dev:.4f} host "
        f"{p_host:.4f} dB")
    assert size_rel <= 0.005, size_rel
    assert abs(p_dev - p_host) <= 0.05, (p_dev, p_host)
    return imgs, streams


def phase_b(streams, times):
    """Pipelined batched device decode against per-stream host decodes."""
    from libjxl_tpu.api import codestream, tpu_codec

    threads = os.cpu_count() or 1
    runs = []
    with Spy(tpu_codec, "decode_tpu_pipelined") as pipe, \
            Spy(tpu_codec, "decode_tpu_batch") as single:
        for _ in range(2):
            outs, t = timed(codestream.decode_batch, streams,
                            num_threads=threads)
            runs.append(t)
    batched = pipe.calls + single.calls
    assert batched == 2 and pipe.failures + single.failures == 0, \
        "decode_batch left the batched device path"
    times["b_cold_s"], times["b_warm_s"] = runs
    worst, worst_frac = 0, 0.0
    t_host = []
    for s, got in zip(streams, outs):
        ref, t = timed(codestream.decode, s, device=False,
                       num_threads=threads)
        t_host.append(t)
        m, f = check_pixels("phase b", got, ref[0])
        worst, worst_frac = max(worst, m), max(worst_frac, f)
    times["b_host_decode_s"] = statistics.median(t_host)
    log(f"phase b: decode_batch of {len(streams)} streams ("
        f"{'pipelined' if pipe.calls else 'one batch'}), cold "
        f"{runs[0]:.3f}s warm {runs[1]:.3f}s; host decode median "
        f"{times['b_host_decode_s']:.3f}s/stream; max |du8| {worst}, "
        f"worst differing fraction {worst_frac:.2e}")


def device_decode(data, want_path, times, key):
    """decode() through make_device_render, cold and warm, checked
    against the host decoder."""
    from libjxl_tpu.api import codestream

    runs = []
    for _ in range(2):
        info = {}
        (px, _), t = timed(codestream.decode, data, decode_info=info)
        assert info.get("path") == want_path, (key, info.get("path"))
        runs.append(t)
    times[f"{key}_cold_s"], times[f"{key}_warm_s"] = runs
    ref, t_host = timed(codestream.decode, data, device=False)
    times[f"{key}_host_s"] = t_host
    m, f = check_pixels(key, px, ref[0])
    return m, f


def phase_c(n, e3_stream, e7_stream, times):
    from libjxl_tpu.vardct import ac_strategy as acs

    m3, f3 = device_decode(e3_stream, "device:u8", times, "c_e3")
    strats = strategies_used(e7_stream)
    assert strats - {acs.DCT}, f"e7 stream is all-DCT8: {strats}"
    m7, f7 = device_decode(e7_stream, "device:u8", times, "c_e7")
    log(f"phase c: single-stream device decode; e3 cold "
        f"{times['c_e3_cold_s']:.3f}s (first call: compile + run) warm "
        f"{times['c_e3_warm_s']:.3f}s host {times['c_e3_host_s']:.3f}s "
        f"max |du8| {m3} frac {f3:.2e}; e7 ({len(strats)} strategies) "
        f"cold {times['c_e7_cold_s']:.3f}s warm {times['c_e7_warm_s']:.3f}s "
        f"host {times['c_e7_host_s']:.3f}s max |du8| {m7} frac {f7:.2e}")
    log(f"decode {n}^2 first-call compile "
        f"~ {times['c_e3_cold_s'] - times['c_e3_warm_s']:.3f}s "
        "(cold minus warm)")


def phase_d(img, ba_n, times):
    """e7 encode with the device heuristics; device vs host Butteraugli."""
    from libjxl_tpu.api import codestream
    from libjxl_tpu.metrics.butteraugli import butteraugli_diffmap
    from libjxl_tpu.metrics.butteraugli_jax import butteraugli_diffmap_jax
    from libjxl_tpu.vardct import frame as vf
    from libjxl_tpu.vardct import heuristics

    runs = []
    with Spy(heuristics, "_refine_device") as refine, \
            Spy(vf, "_tile_cost_device") as tiles:
        for _ in range(2):
            s7, t = timed(codestream.encode_lossy, img, distance=1.0,
                          effort=7)
            runs.append(t)
    assert refine.calls == 2 and tiles.calls > 0, \
        (refine.calls, tiles.calls)
    times["d_cold_s"], times["d_warm_s"] = runs
    px = codestream.decode(s7, device=False)[0]
    p7 = psnr(px, img)
    assert px.shape == img.shape and p7 > 30.0, (px.shape, p7)
    rng = np.random.default_rng(5)
    a = (make_image(ba_n, seed=7).astype(np.float32) / 255.0) ** 2.2
    b = np.clip(a + rng.normal(0, 0.01, a.shape), 0, 1)
    a, b = np.moveaxis(a, -1, 0), np.moveaxis(b, -1, 0).astype(np.float32)
    host, t_host = timed(butteraugli_diffmap, a, b)
    dev = np.asarray(butteraugli_diffmap_jax(a, b))
    _, t_dev = timed(lambda: np.asarray(butteraugli_diffmap_jax(a, b)))
    rel = float((np.abs(host - dev) / (np.abs(host) + 1e-3)).max())
    log(f"phase d: {img.shape[0]}^2 d1/e7 encode cold {runs[0]:.3f}s "
        f"warm {runs[1]:.3f}s ({len(s7)} bytes, PSNR {p7:.3f} dB, "
        f"{tiles.calls} device tile-cost calls); Butteraugli "
        f"{ba_n}^2 device (float32, Precision.HIGHEST blur products) vs "
        f"host float64: max rel err {rel:.3e}, device warm "
        f"{t_dev:.3f}s host {t_host:.3f}s")
    assert rel <= 1e-3, rel
    return s7


def gate_timings(times):
    """Device vs host single-stream decode around the 1 MP
    DEVICE_AUTO_MIN_PIXELS gate."""
    from libjxl_tpu.api import codestream

    for n in (512, 1024):
        s = codestream.encode_lossy(make_image(n, seed=n), distance=1.0,
                                    effort=3, device=False)
        dev = []
        for _ in range(3):
            dev.append(timed(codestream.decode, s, device=True)[1])
        host = [timed(codestream.decode, s, device=False)[1]
                for _ in range(2)]
        times[f"gate_{n}"] = {"device_cold_s": dev[0],
                              "device_warm_s": min(dev[1:]),
                              "host_s": min(host)}
        log(f"gate {n}^2: device decode cold {dev[0]:.3f}s warm "
            f"{min(dev[1:]):.3f}s, host decode {min(host):.3f}s")


def run_gpu_tests():
    """The suite's `gpu`-marked tests, in this process on the card:
    tests/test_gpu.py, then phase e, the conformance corpus decoded on
    the device path against its stored reference pixels (the bounds of
    tests/test_conformance_oracle.py), cold and warm."""
    import pytest

    # tests/conftest.py pins the CPU mesh unless a platform is chosen
    os.environ["JAX_PLATFORMS"] = "cuda"
    times = {}
    for key, name in (("gpu_tests", "test_gpu.py"),
                      ("e_cold", "test_conformance_oracle.py"),
                      ("e_warm", "test_conformance_oracle.py")):
        t0 = time.perf_counter()
        rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                          os.path.join(REPO, "tests", name)])
        times[f"{key}_s"] = time.perf_counter() - t0
        log(f"{key}: gpu-marked tests of {name} exit {int(rc)} in "
            f"{times[f'{key}_s']:.1f}s")
        assert rc == 0, f"{name}: gpu-marked tests failed (exit {int(rc)})"
    return times


def run_one_card(n=N, count=N_STREAMS, ba_n=512):
    times = {}
    t0 = time.perf_counter()
    imgs, streams = phase_a(n, count, times)
    phase_b(streams, times)
    s7 = phase_d(imgs[0], ba_n, times)
    phase_c(n, streams[0], s7, times)
    del imgs
    gate_timings(times)
    log(f"phases a-d done in {time.perf_counter() - t0:.1f}s")
    return times


# -------------------------------------------------------------- four cards
def run_four(devices, big_mp=64.0, n_batch=16, batch_n=N):
    import jax
    from jax.sharding import Mesh

    import __graft_entry__ as graft
    from libjxl_tpu.api import codestream
    from libjxl_tpu.api.tpu_codec import (decode_tpu_batch,
                                          decode_tpu_batch_sharded,
                                          place_batch, prepare_tpu_batch)

    nd = len(devices)
    rows_mesh = Mesh(np.array(devices), ("rows",))
    r = graft._dryrun_big_image_sharded_decode(rows_mesh, nd,
                                               target_mp=big_mp)
    log("four: big image " + json.dumps(r))
    streams = [codestream.encode_lossy(make_image(batch_n, seed=300 + i),
                                       distance=1.0, effort=3)
               for i in range(n_batch)]
    one = decode_tpu_batch(streams)
    _, t_one = timed(decode_tpu_batch, streams)
    mesh = Mesh(np.array(devices), ("batch",))
    shd = decode_tpu_batch_sharded(streams, mesh=mesh)
    shd, t_shd = timed(decode_tpu_batch_sharded, streams, mesh=mesh)
    # each card runs the same per-image program: bit-exact
    for i, (a, b) in enumerate(zip(shd, one)):
        assert np.array_equal(a, b), ("batch sharded", i, int(np.abs(
            a.astype(np.int16) - b.astype(np.int16)).max()))
    # the render alone, inputs resident: one card vs the batch axis
    # split over all cards (as decode_tpu_batch_sharded places it)
    prog, args = prepare_tpu_batch(streams)
    r1 = render_time(prog, jax.device_put(args, devices[0]))
    rn = render_time(prog, place_batch(args, mesh))
    log(f"four: decode_tpu_batch_sharded {n_batch} x {batch_n}^2 over "
        f"{nd} cards {t_shd:.3f}s vs decode_tpu_batch on one card "
        f"{t_one:.3f}s (both incl. host entropy); render alone "
        f"{rn:.4f}s on {nd} cards vs {r1:.4f}s on one; pixel-exact")


def render_time(prog, dev_args, reps=3):
    import jax

    jax.block_until_ready(prog(*dev_args))
    ts = [timed(lambda: jax.block_until_ready(prog(*dev_args)))[1]
          for _ in range(reps)]
    return statistics.median(ts)


# ------------------------------------------------------------------- main
def card_lines():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    except (OSError, subprocess.SubprocessError):
        return []


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    cards = card_lines()
    for ln in cards or ["nvidia-smi: no card found"]:
        log(f"card: {ln}")

    import libjxl_tpu  # sets the compile cache before jax is imported
    import jax

    from libjxl_tpu import native_ext

    log(f"jax {jax.__version__}, python {sys.version.split()[0]}, "
        f"libjxl_tpu {libjxl_tpu.__version__}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    backend = jax.default_backend()
    if backend != "gpu":
        log(f"FAIL: JAX backend is {backend!r}, not 'gpu'")
        return 2
    native = native_ext.get_lib() is not None
    log(f"native C library loaded: {native}")
    if not native:
        log("FAIL: native C library did not load (host entropy would "
            "run the pure-Python path)")
        return 3
    devices = jax.devices()
    log(f"devices: {len(devices)} x {devices[0].device_kind}")
    if args.four:
        if len(devices) < 4:
            log(f"FAIL: --four needs 4 GPUs, found {len(devices)}")
            return 4
        devices = devices[:4]
        run_four(devices)
    else:
        times = run_gpu_tests()
        times.update(run_one_card())
        log("times " + json.dumps(times, sort_keys=True))
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
