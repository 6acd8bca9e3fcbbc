#!/bin/bash
# End-to-end CLI smoke test (tools/bash_test.sh analog).
set -e
PY=${PY:-python}
export PYTHONPATH=${PYTHONPATH:-$(pwd)}
# CLI-logic smoke test on the CPU backend (the device path has
# chip_smoke.py)
export JAX_PLATFORMS=cpu
TMP=$(mktemp -d)
trap 'rm -rf "$TMP"' EXIT

$PY - <<PYEOF
import numpy as np
import sys; sys.path.insert(0, "$(pwd)")
from libjxl_tpu.extras.io import save_image
rng = np.random.default_rng(0)
yy, xx = np.mgrid[0:120, 0:150]
img = np.stack([np.clip(100+xx/2,0,255), np.clip(60+yy/2,0,255),
                np.full((120,150),130)], -1).astype(np.uint8)
save_image("$TMP/in.png", img)
PYEOF

echo "== lossy roundtrip"
$PY -m libjxl_tpu.tools.cjxl "$TMP/in.png" "$TMP/d1.jxl" -d 1.0
$PY -m libjxl_tpu.tools.djxl "$TMP/d1.jxl" "$TMP/d1.png"
$PY -m libjxl_tpu.tools.jxlinfo "$TMP/d1.jxl"

echo "== lossless roundtrip (bit-exact)"
$PY -m libjxl_tpu.tools.cjxl "$TMP/in.png" "$TMP/ll.jxl" -m 1
$PY -m libjxl_tpu.tools.djxl "$TMP/ll.jxl" "$TMP/ll.png"
$PY - <<PYEOF
import numpy as np, sys
sys.path.insert(0, "$(pwd)")
from libjxl_tpu.extras.io import load_image
assert np.array_equal(load_image("$TMP/in.png"), load_image("$TMP/ll.png"))
print("bit-exact OK")
PYEOF

echo "== container + progressive + preview"
$PY -m libjxl_tpu.tools.cjxl "$TMP/in.png" "$TMP/c.jxl" -d 1.5 -p 2 --preview 48 --container
$PY -m libjxl_tpu.tools.djxl "$TMP/c.jxl" "$TMP/c.png" --preview_out "$TMP/pv.png"
test -f "$TMP/pv.png"

echo "== error handling"
head -c 40 "$TMP/d1.jxl" > "$TMP/trunc.jxl"
if $PY -m libjxl_tpu.tools.djxl "$TMP/trunc.jxl" "$TMP/x.png" 2>/dev/null; then
  echo "FAIL: truncated decode should error"; exit 1
fi
echo "clean error on truncation OK"

echo "== benchmark"
$PY -m libjxl_tpu.tools.benchmark "$TMP/in.png" --codec d1.0,m | tail -3

echo "ALL BASH TESTS PASSED"
