"""Attribute the device time of the served batched render to its stages.

B=16 distinct 2048x2048 d1/e3 streams go through the served batched
program (tpu_codec.prepare_tpu_batch). Its steady-state calls are traced
with jax.profiler; each device op is attributed through the op_name of
its HLO instruction (EPF runs under the named scope "epf_pass"). EPF
work that XLA fused into a neighbouring fusion is counted as other
work, so the EPF share is a lower bound.

Run on the GPU from the repo root:

    python tools/device_stage_times.py [--out chiprun_out/stage_times]

Prints the card and one summary line, and writes summary.json, the
compiled HLO and the trace under --out. Exits non-zero when JAX finds
no GPU.
"""

import argparse
import glob
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

B = 16
N = 2048


def _key(name):
    """Kernel and HLO instruction names agree up to '.'/'-' vs '_'."""
    return re.sub(r"[.\-]", "_", name)


def _op_names(compiled_text):
    """HLO instruction name (normalized) -> op_name metadata."""
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')
    out = {}
    for ln in compiled_text.splitlines():
        m = pat.match(ln)
        if m:
            out.setdefault(_key(m.group(1)), m.group(2))
    return out


def _device_events(xplane_path):
    """(op name, duration_ns) of every GPU op in the trace. Inside a
    CUDA graph hlo_op reads "command_buffer" and the kernel's own name
    is the HLO fusion's."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU")]
    events, line_names = [], set()
    for plane in planes:
        lines = list(plane.lines)
        ops = [ln for ln in lines if ln.name == "XLA Ops"]
        for ln in ops or lines:
            for ev in ln.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if op is None:
                    continue
                if op == "command_buffer":
                    op = ev.name
                line_names.add(ln.name)
                events.append((_key(str(op)), float(ev.duration_ns)))
    return events, sorted(line_names)


def epf_share_from_trace(prog, args, out_dir, reps=3):
    import jax

    text = prog.lower(*args).compile().as_text()
    with open(os.path.join(out_dir, "batched_render.hlo.txt"), "w") as f:
        f.write(text)
    names = _op_names(text)
    jax.block_until_ready(prog(*args))
    tdir = os.path.join(out_dir, "trace")
    t0 = time.perf_counter()
    with jax.profiler.trace(tdir):
        for _ in range(reps):
            jax.block_until_ready(prog(*args))
    wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    events, lines = _device_events(path)
    total = sum(d for _, d in events)
    epf = sum(d for op, d in events if "epf_pass" in names.get(op, ""))
    unmatched = sum(1 for op, _ in events if op not in names)
    return {"device_op_ms_per_call": total / 1e6 / reps,
            "epf_ms_per_call": epf / 1e6 / reps,
            "epf_share": epf / total if total else None,
            "traced_wall_s": wall, "events": len(events),
            "events_without_hlo_metadata": unmatched,
            "trace_lines": lines}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/stage_times")
    args = ap.parse_args(argv)
    from chip_smoke import card_lines, make_image

    card = "; ".join(card_lines()) or "nvidia-smi: no card found"
    print(f"card: {card}", flush=True)

    import jax

    from libjxl_tpu.api import codestream, tpu_codec

    if jax.default_backend() != "gpu":
        print(f"FAIL: backend {jax.default_backend()}, not gpu")
        return 2
    dev = jax.devices()[0]
    os.makedirs(args.out, exist_ok=True)
    streams = [codestream.encode_lossy(make_image(N, seed=500 + i),
                                       distance=1.0, effort=3, device=True)
               for i in range(B)]
    prog, pargs = tpu_codec.prepare_tpu_batch(streams)
    pargs = jax.device_put(pargs)
    res = {"card": card, "device_kind": dev.device_kind, "size": N,
           "batch": B}
    res["trace"] = epf_share_from_trace(prog, pargs, args.out)
    print(f"batched render B={B} {N}^2: device ops "
          f"{res['trace']['device_op_ms_per_call']:.3f} ms/call, EPF "
          f"{res['trace']['epf_ms_per_call']:.3f} ms/call (share "
          f"{res['trace']['epf_share']}) from the trace", flush=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
