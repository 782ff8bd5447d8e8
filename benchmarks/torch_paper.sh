#!/usr/bin/env bash
# The paper's experiments on the PyTorch/CUDA port, in order, each with
# its wall time:
#   the collect + train CLI at its defaults (writes models/dial.*),
#   Table II and Fig. 3 at the paper's seconds (--json beside the rows),
#   and the four examples.
# Run from the repository's root, on the card:
#     bash benchmarks/torch_paper.sh [OUT_DIR]          (default results/paper)
# OUT_DIR gets each step's log, walls.txt, the card's name and power
# limit, the two tables' JSON and a copy of the trained model.
set -euo pipefail
out=${1:-results/paper}
mkdir -p "$out"
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
: > "$out/walls.txt"

step() {
    local name=$1 t0 t1
    shift
    t0=$(date +%s%N)
    "$@" 2>&1 | tee "$out/$name.log"
    t1=$(date +%s%N)
    echo "$name: $(( (t1 - t0) / 1000000 )) ms wall" | tee -a "$out/walls.txt"
}

step cli python3 -m repro_torch.core.dataset --out models/dial
cp models/dial.read.npz models/dial.write.npz "$out/"
step table2 python3 benchmarks/torch_table2_h5bench.py --json "$out/table2.json"
step fig3 python3 benchmarks/torch_fig3_dlio.py --json "$out/fig3.json"
step quickstart python3 examples/torch_quickstart.py
step dial_vs_static python3 examples/torch_dial_vs_static.py
step serve_batch python3 examples/torch_serve_batch.py
step train_with_dial python3 examples/torch_train_with_dial.py
