"""Benchmark: end-to-end VarDCT decode throughput on one GPU.

The HEADLINE (`value`) is end-to-end: batched decode of N distinct real
bitstreams with EVERYTHING on the clock (host rANS entropy decode +
argument staging + device dispatch + full u8 pixel readback), through
the public serving pipeline `api/tpu_codec.decode_tpu_pipelined` (host
entropy of batch k+1 overlapped with device render + readback of batch
k). This matches what the reference clocks for its ~400 MP/s design
target — one path, nothing excluded (dec_frame.cc:568,716;
doc/xl_overview.md:7-9).

Setup: synthesize N distinct 2048x2048 photo-like images (independent
noise fields), encode each at d1/e3 with this package's encoder (real
VarDCT streams: adaptive quant field, CfL, gaborish+EPF signaled).
All N streams are distinct so no execution cache can fire.

Secondary fields (each a measured wall clock on this machine):
- render_mp_s: device render only, one vmapped dispatch over 16
  distinct streams, device-side checksum readback.
- entropy_mp_s: host C entropy decode of one stream (pthread pool over
  the host's cores).
- e2e_single_mp_s: unpipelined single-stream decode (entropy +
  staging + render + readback of one image).
- encode_mp_s: e3 device-encoder rate on the same content.
- encode_e7_mp_s: full-heuristics e7 encode rate (device AQ field +
  device Butteraugli-feedback refinement + ACS search + host entropy).

vs_baseline = value / 400 (the reference's multithreaded-CPU decode
design target).

Run on a GPU: python bench.py. It prints the card (name, power limit)
on stderr and one JSON line on stdout, and exits non-zero when JAX's
backend is not a GPU.
"""

import json
import os
import statistics
import sys
import time

import numpy as np


def _have(cmd):
    import shutil

    return shutil.which(cmd) is not None


def _make_image(n=2048, seed=42):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    img = (120 + 60 * np.sin(xx * 0.003) + 50 * np.cos(yy * 0.002 + 1)
           + 20 * np.sin((xx + yy) * 0.01) + rng.normal(0, 5, (n, n)))
    rgb = np.stack([img, img * 0.9 + 10, img * 1.1 - 12], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def main():
    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip() if _have("nvidia-smi") else "none"
    print(f"bench: card {card}", file=sys.stderr, flush=True)

    import libjxl_tpu  # noqa: F401  (compile cache before jax import)
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        print(f"bench: backend {jax.default_backend()!r} is not a GPU",
              file=sys.stderr, flush=True)
        sys.exit(2)
    from libjxl_tpu.api import codestream
    from libjxl_tpu.api.codestream import parse_codestream_header
    from libjxl_tpu.api.tpu_codec import (decode_tpu_batch,
                                          decode_tpu_pipelined,
                                          prepare_tpu_batch)
    from libjxl_tpu.io.bits import BitReader
    from libjxl_tpu.io.frame_header import FrameHeader
    from libjxl_tpu.vardct import frame as vf

    n = 2048
    mp = n * n / 1e6
    batch = 16
    n_streams = int(os.environ.get("BENCH_STREAMS", "48"))
    n_streams = max(batch, (n_streams // batch) * batch)
    print(f"bench: encoding {n_streams} distinct streams...",
          file=sys.stderr, flush=True)
    codestream.encode_lossy(_make_image(n, seed=999), distance=1.0,
                            effort=3)  # warm (jit)
    streams = []
    t_enc = None
    for i in range(n_streams):
        img = _make_image(n, seed=100 + i)
        t0 = time.time()
        streams.append(codestream.encode_lossy(img, distance=1.0,
                                               effort=3))
        if t_enc is None:
            t_enc = time.time() - t0
            print(f"bench: first encode {t_enc:.1f}s", file=sys.stderr,
                  flush=True)
    assert len(set(streams)) == n_streams, "streams must be distinct"

    # --- host entropy decode (C hot loop) of one real bitstream
    n_threads = os.cpu_count() or 1

    def entropy_decode(threads=n_threads):
        r = BitReader(streams[0])
        meta = parse_codestream_header(r)
        fh = FrameHeader(meta)
        fh.read(r)
        cap = {}

        def capture(state):
            cap["state"] = state
            state.restoration_done = True
            state.device_output_done = True

        vf.decode_vardct_frame(r, fh, render_fn=capture, want_qimg=True,
                               num_threads=threads)
        return cap["state"], fh

    entropy_decode()  # warm (builds native tables)
    times = []
    for _ in range(3):
        t0 = time.time()
        entropy_decode()
        times.append(time.time() - t0)
    t_entropy = statistics.median(times)

    # --- device render only: one vmapped dispatch over 16 DISTINCT
    # streams, checksum readback
    B = batch
    print(f"bench: preparing+compiling batch (B={B})...",
          file=sys.stderr, flush=True)
    prog, args = prepare_tpu_batch(streams[:B])
    args = jax.device_put(args)

    @jax.jit
    def chk_prog(*a):
        # per-image checksum on device: tiny readback, times ONLY the
        # render stage (readback excluded by design — the e2e headline
        # includes it)
        return prog(*a).astype(jnp.int32).sum(axis=(1, 2, 3))

    t0 = time.time()
    chks = np.asarray(chk_prog(*args))
    print(f"bench: compiled+ran in {time.time()-t0:.0f}s",
          file=sys.stderr, flush=True)
    assert len(set(int(c) for c in chks)) == B, \
        "batch lanes must produce distinct images"
    times = []
    for _ in range(4):
        t0 = time.time()
        np.asarray(chk_prog(*args))
        times.append(time.time() - t0)
    t_render = statistics.median(times)
    render_mp_s = mp * B / t_render

    # --- HEADLINE: pipelined end-to-end over all N distinct streams.
    # Everything on the clock: entropy + staging + dispatch + full u8
    # pixel readback. The B=16 render program is compiled by the
    # render-only stage above; the first pipelined run below is
    # steady-state work, not compilation.
    print(f"bench: pipelined e2e over {n_streams} streams...",
          file=sys.stderr, flush=True)
    e2e_times = []
    for _ in range(2):
        t0 = time.time()
        outs = decode_tpu_pipelined(streams, batch_size=batch)
        e2e_times.append(time.time() - t0)
        print(f"bench: pipelined pass {e2e_times[-1]:.2f}s",
              file=sys.stderr, flush=True)
    t_e2e_pipe = min(e2e_times)
    # correctness guard: full pixels came back, all distinct
    sums = {int(o.astype(np.int64).sum()) for o in outs}
    assert len(sums) == n_streams, "pipelined outputs must be distinct"
    assert outs[0].shape == (n, n, 3) and outs[0].dtype == np.uint8
    e2e_pipe_mp_s = mp * n_streams / t_e2e_pipe

    # --- unpipelined single-stream end-to-end (public API)
    decode_tpu_batch([streams[0]])  # warm the B=1 program
    t0 = time.time()
    decode_tpu_batch([streams[1 % n_streams]])
    t_e2e1 = time.time() - t0

    # --- e7 encode (full heuristics: device AQ field + device
    # Butteraugli-feedback refinement + ACS search + host entropy),
    # steady state after the compiling first call
    e7_n = 2048
    img7 = _make_image(e7_n, seed=777)
    codestream.encode_lossy(img7, distance=1.0, effort=7)  # compile
    times7 = []
    for _ in range(2):
        t0 = time.time()
        codestream.encode_lossy(img7, distance=1.0, effort=7)
        times7.append(time.time() - t0)
    e7_mp_s = round((e7_n * e7_n / 1e6) / statistics.median(times7), 3)
    print(f"bench: e7 encode {statistics.median(times7):.1f}s at "
          f"{e7_n}^2", file=sys.stderr, flush=True)

    value = round(e2e_pipe_mp_s, 2)
    print(json.dumps({
        "metric": "vardct_e2e_decode_pipelined",
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "value": value,
        "unit": "MP/s",
        "vs_baseline": round(value / 400.0, 3),
        "streams": n_streams,
        "batch": batch,
        "pipelined_wall_s": round(t_e2e_pipe, 3),
        "render_mp_s": round(render_mp_s, 2),
        "render_dispatch_s": round(t_render, 4),
        "entropy_mp_s": round(mp / t_entropy, 2),
        "entropy_threads": n_threads,
        "e2e_single_mp_s": round(mp / t_e2e1, 2),
        "encode_mp_s": round(mp / t_enc, 3),
        "encode_e7_mp_s": e7_mp_s,
        "encode_e7_shape": e7_n,
        "checksum": int(chks[0]),
    }))


if __name__ == "__main__":
    main()
