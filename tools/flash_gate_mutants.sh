#!/usr/bin/env bash
# Check that chip_smoke.py's flash-attention gate catches a faulty kernel.
#
#   bash tools/flash_gate_mutants.sh [OUT_DIR]     (from the repo root, on a CUDA machine)
#
# For each planted fault, copies chip_smoke.py and ptdeco_tpu_torch/ to a
# fresh directory under ${TMPDIR:-/tmp}, edits one line of
# csrc/flash_attention_fwd.cu there, and runs chip_smoke.py in the copy.
# The run must fail at the flash_attention kernel check; its output is
# kept as OUT_DIR/mutant_<name>.txt (default chiprun_out/).  Exits non-zero
# if any faulty kernel passes.
set -u
out_dir=${1:-chiprun_out}
mkdir -p "$out_dir"
declare -A SED=(
  [scale_x1.02]='s/const float scale_log2 = sm_scale \* 1.4426950408889634f;/const float scale_log2 = sm_scale * 1.02f * 1.4426950408889634f;/'
  [o_without_alpha]='s/oacc\[dt\]\[\([0-3]\)\] \*= alpha_\([ab]\);/(void)alpha_\2;/'
  [diag_tile_dropped]='s/for (int kt = 0; kt <= qt; ++kt)/for (int kt = 0; kt < qt; ++kt)/'
)
src=ptdeco_tpu_torch/csrc/flash_attention_fwd.cu
escaped=0
for m in scale_x1.02 o_without_alpha diag_tile_dropped; do
  d=$(mktemp -d "${TMPDIR:-/tmp}/flash_mutant_$m.XXXX")
  cp -r chip_smoke.py ptdeco_tpu_torch "$d"/
  sed -i "${SED[$m]}" "$d/$src"
  if cmp -s "$src" "$d/$src"; then
    echo "$m: the edit did not apply"; escaped=1; rm -rf "$d"; continue
  fi
  (cd "$d" && timeout 300 python3 chip_smoke.py) > "$out_dir/mutant_$m.txt" 2>&1
  rc=$?
  caught=$(grep -c '"name": "flash_attention".*"ok": false' "$out_dir/mutant_$m.txt")
  echo "$m: rc=$rc caught_by_flash_gate=$caught"
  grep '"name": "flash_attention"' "$out_dir/mutant_$m.txt"
  if [ "$rc" -eq 0 ] || [ "$caught" -eq 0 ]; then escaped=1; fi
  rm -rf "$d"
done
exit $escaped
