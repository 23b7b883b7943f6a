"""Design-space exploration of the PyTorch port: the sweep of
``examples/dse_explore.py`` on ``repro_torch``'s simulator.

Sweeps, for a stablelm-1.6b train step on the reference's v5e pod (the
port's copy of ``v5e_pod``, built bit for bit):
  * HBM bandwidth 0.5x..2x
  * ICI link bandwidth 0.5x..2x
  * collective algorithm            (ring vs torus vs hierarchical)
  * comm/compute overlap on/off

The step's costs come from the port's own dry run of the cell when its
file is there (``python -m repro_torch.launch.dryrun --all
--single-pod-only`` writes ``results/dryrun_torch/``), else from the
original's analytic estimate.  It prints the original's lines; nothing
here imports JAX or the ``repro`` package, and nothing runs on a device.

Run:  PYTHONPATH=src python examples/dse_explore_torch.py
"""

import json
import os

from repro_torch.core.desim.collectives import ALGORITHMS
from repro_torch.core.desim.machine import TPU_V5E, TPU_V5E_LINKS
from repro_torch.core.desim.trace import analytic_trace
from repro_torch.sim import v5e_pod

ART = "results/dryrun_torch/stablelm-1.6b__train_4k__single.json"
if os.path.exists(ART):
    with open(ART) as f:
        r = json.load(f)["roofline"]
    L = 24
    flops, nbytes = r["hlo_flops_per_device"] / L, r["hlo_bytes_per_device"] / L
    coll = r["collective_bytes_per_device"] / L * 256
    src = "real dry-run artifact"
else:
    L, flops, nbytes, coll = 24, 2.4e12, 2.2e11, 1.3e11
    src = "analytic estimate"
print(f"workload: stablelm-1.6b train_4k ({src})")

rows = []
for hbm_mult in (0.5, 1.0, 2.0):
    for ici_mult in (0.5, 1.0, 2.0):
        for alg in ALGORITHMS:
            for overlap in (False, True):
                board = v5e_pod(chip={"hbm_bw": TPU_V5E["hbm_bw"] * hbm_mult},
                                ici={"bw": TPU_V5E_LINKS["ici"]["bw"]
                                     * ici_mult},
                                algorithm=alg)
                tr = analytic_trace(
                    "w", L, flops, nbytes,
                    [{"kind": "all-reduce", "bytes": coll,
                      "participants": 256}], overlap=overlap)
                t = board.executor().execute(tr).makespan_s
                rows.append((t, hbm_mult, ici_mult, alg, overlap))

rows.sort()
print(f"{len(rows)} configurations simulated")
print("best 5:")
for t, hbm, ici, alg, ovl in rows[:5]:
    print(f"  {t:8.4f}s  hbm x{hbm} ici x{ici} alg={alg:12s} overlap={ovl}")
print("worst:")
t, hbm, ici, alg, ovl = rows[-1]
print(f"  {t:8.4f}s  hbm x{hbm} ici x{ici} alg={alg:12s} overlap={ovl}")
base = [r for r in rows if r[1] == 1.0 and r[2] == 1.0][0]
print(f"\ninsight: best config is {rows[-1][0]/rows[0][0]:.1f}x faster than "
      f"worst; at nominal hardware the best software-only choice gives "
      f"{base[0]:.4f}s (alg={base[3]}, overlap={base[4]})")
print("dse_explore OK")
