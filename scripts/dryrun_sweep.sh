#!/usr/bin/env bash
# Write the dry run's records for every (arch x shape x mesh) cell, the
# records `python -m repro_torch.launch.dryrun --all --mesh both` writes,
# with one process per cell, N at a time (default: the CPU count), the
# deepest archs first (the blockwise attention at 32k tokens dominates).
#
#   scripts/dryrun_sweep.sh OUT_DIR [N]
#
# Each cell's output goes to OUT_DIR/<arch>__<shape>__<mesh>.log and its
# seconds to OUT_DIR/seconds.txt; render the tables with
#   PYTHONPATH=src python -m repro_torch.analysis.report --dir OUT_DIR
set -euo pipefail
cd "$(dirname "$0")/.."
out=${1:?usage: scripts/dryrun_sweep.sh OUT_DIR [N]}
jobs=${2:-$(nproc)}
mkdir -p "$out"
PYTHONPATH=src python3 - <<'PY' > "$out/cells.txt"
from repro_torch.configs import ARCHS, SHAPES
order = {"prefill_32k": 0, "train_4k": 1, "decode_32k": 2, "long_500k": 3}
# attention layers (an encoder's count twice: it feeds cross-attention)
attn = {a: sum(c.layer_kind(l)[0] == "attn" for l in range(c.n_layers)) + 2 * c.encoder_layers
        for a, c in ARCHS.items()}
cells = [(-attn[a], order[s], a, s, m)
         for a in ARCHS for s in SHAPES for m in ("single", "multipod")]
for *_, a, s, m in sorted(cells):
    print(a, s, m)
PY
export OUT="$out"
xargs -P "$jobs" -L 1 sh -c '
  start=$(date +%s)
  PYTHONPATH=src python3 -m repro_torch.launch.dryrun --arch "$0" --shape "$1" --mesh "$2" \
      --out "$OUT" > "$OUT/$0__$1__$2.log" 2>&1
  echo "$0 $1 $2 rc=$? $(( $(date +%s) - start ))" >> "$OUT/seconds.txt"
' < "$out/cells.txt"
ls "$out"/*.json | wc -l
