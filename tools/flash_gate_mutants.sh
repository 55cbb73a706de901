#!/usr/bin/env bash
# Check that chip_smoke.py's kernel gates catch a faulty flash-attention,
# grouped-matmul or int8 grouped-matmul kernel.
#
#   bash tools/flash_gate_mutants.sh [OUT_DIR [FAULT ...]]
#                                  (from the repo root, on a CUDA machine)
#
# For each planted fault, copies chip_smoke.py and ptdeco_tpu_torch/ to a
# fresh directory under ${TMPDIR:-/tmp}, edits one line of a kernel source
# there, and runs chip_smoke.py in the copy.  The run must fail at that
# kernel's check; its output is kept as OUT_DIR/mutant_<name>.txt (OUT_DIR's
# default is set on the out_dir line below).  The faults: flash attention's
# scale off by 2%, its O accumulators not rescaled when the row max rises,
# its diagonal key tile dropped; the grouped matmul's wgmma route storing a
# tile's rows past its group (into the next expert's rows); the int8
# grouped matmul's decode route dropping one split-K partial from its
# cluster's sum, and leaving the scale off the last 128-column tile's
# channels; its batch route storing one row past its group (the next
# expert's first row, or the next tile's).  FAULT names run only those
# faults.  Exits non-zero if any faulty kernel passes or an edit does not
# apply.
set -u
out_dir=${1:-chiprun_out}
mkdir -p "$out_dir"
flash=ptdeco_tpu_torch/csrc/flash_attention_fwd.cu
grouped=ptdeco_tpu_torch/csrc/grouped_matmul.cu
int8=ptdeco_tpu_torch/csrc/gmm_int8.cu
declare -A SRC=(
  [scale_x1.02]=$flash [o_without_alpha]=$flash [diag_tile_dropped]=$flash
  [store_past_group]=$grouped [int8_partial_dropped]=$int8 [int8_last_tile_unscaled]=$int8
  [int8_next_group_row_stored]=$int8
)
declare -A GATE=(
  [scale_x1.02]=flash_attention [o_without_alpha]=flash_attention
  [diag_tile_dropped]=flash_attention [store_past_group]=grouped_matmul
  [int8_partial_dropped]=gmm_int8 [int8_last_tile_unscaled]=gmm_int8
  [int8_next_group_row_stored]=gmm_int8
)
declare -A SED=(
  [scale_x1.02]='s/const float scale_log2 = sm_scale \* 1.4426950408889634f;/const float scale_log2 = sm_scale * 1.02f * 1.4426950408889634f;/'
  [o_without_alpha]='s/oacc\[4 \* q\( + [1-3]\)\?\] \*= alpha_\([ab]\);/(void)alpha_\2;/'
  [diag_tile_dropped]='s/const int n_blocks = (tile.qt + 1) \* (kBM \/ kBN);/const int n_blocks = tile.qt * (kBM \/ kBN);/'
  [store_past_group]='s/const int row_end = r1;/const int row_end = m;/'
  [int8_partial_dropped]='s/for (int s = 0; s < ks; ++s) {/for (int s = 1; s < ks; ++s) {/'
  [int8_last_tile_unscaled]='s/const float s0 = sc\[j\], s1 = j + 1 < cols ? sc\[j + 1\] : 0.f;/const bool last = blockIdx.y + 1 == gridDim.y; const float s0 = last ? 1.f : sc[j], s1 = last ? 1.f : (j + 1 < cols ? sc[j + 1] : 0.f);/'
  [int8_next_group_row_stored]='s/const int store_rows = r1 - r0;/const int store_rows = min(r1 - r0 + 1, m - r0);/'
)
faults=(scale_x1.02 o_without_alpha diag_tile_dropped store_past_group int8_partial_dropped
        int8_last_tile_unscaled int8_next_group_row_stored)
if [ $# -gt 1 ]; then faults=("${@:2}"); fi
escaped=0
for m in "${faults[@]}"; do
  src=${SRC[$m]}
  d=$(mktemp -d "${TMPDIR:-/tmp}/kernel_mutant_$m.XXXX")
  cp -r chip_smoke.py ptdeco_tpu_torch "$d"/
  sed -i "${SED[$m]}" "$d/$src"
  if cmp -s "$src" "$d/$src"; then
    echo "$m: the edit did not apply"; escaped=1; rm -rf "$d"; continue
  fi
  (cd "$d" && timeout 300 python3 chip_smoke.py) > "$out_dir/mutant_$m.txt" 2>&1
  rc=$?
  caught=$(grep -c "\"name\": \"${GATE[$m]}\".*\"ok\": false" "$out_dir/mutant_$m.txt")
  echo "$m: rc=$rc caught_by_${GATE[$m]}_gate=$caught"
  grep "\"name\": \"${GATE[$m]}\"" "$out_dir/mutant_$m.txt"
  if [ "$rc" -eq 0 ] || [ "$caught" -eq 0 ]; then escaped=1; fi
  rm -rf "$d"
done
exit $escaped
