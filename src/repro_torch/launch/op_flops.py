"""Per-op flops and bytes of one production dry-run cell, and the
difference of two.

    PYTHONPATH=src python -m repro_torch.launch.op_flops ARCH SHAPE OUT.json [--layers N]
    PYTHONPATH=src python -m repro_torch.launch.op_flops --diff A.json B.json [--by bytes]

The first form runs ``dryrun.dryrun_cell(ARCH, SHAPE)`` on the
single-pod (16, 16) mesh under the fake process group, as its costed
rank, with ``op_cost.op_cost`` wrapped to sum each op's flops and bytes
by the op and its first three operands' shapes, and writes the cell's
flops and bytes a device and those sums, largest flops first;
``--layers N`` cuts the arch to N layers (two depths' difference is a
layer's share, at a fraction of the full cell's host time).  A train
cell records autograd on fake CUDA tensors, so run it on a host with a
card.  To cost another tree, put its ``src`` first on ``PYTHONPATH``
and run this file by its path.  The second form prints the ops whose
flops (``--by bytes``: whose bytes, what a memory-bound cell's bound
reads) differ between two such files, largest change first.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
from typing import Dict, List, Optional

from repro_torch.core import op_cost
from repro_torch.launch import dryrun as dr


def cell_op_flops(arch: str, shape: str,
                  layers: Optional[int] = None) -> Dict:
    """The cell's flops and bytes a device and its flops and bytes summed
    by op and shapes (the arch cut to ``layers`` layers if given)."""
    sums: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0, 0.0, 0.0])
    cost = op_cost.op_cost

    def counted(func, args, kwargs, out):
        flops, nbytes = cost(func, args, kwargs, out)
        if flops or nbytes:
            shapes = [tuple(t.shape)
                      for t in op_cost._tensors((args, kwargs))][:3]
            entry = sums[f"{func} {shapes}"]
            entry[0] += 1
            entry[1] += flops
            entry[2] += nbytes
        return flops, nbytes
    get_config = dr.get_config
    op_cost.op_cost = counted
    if layers:
        dr.get_config = lambda a: dataclasses.replace(get_config(a),
                                                      n_layers=layers)
    try:
        with dr.fake_process_group(256, dr.costed_rank()):
            res = dr.dryrun_cell(arch, shape)
    finally:
        op_cost.op_cost = cost
        dr.get_config = get_config
    ops = sorted(sums.items(), key=lambda kv: -kv[1][1])
    return {"arch": arch, "shape": shape, "status": res["status"],
            "flops_per_device": res["roofline"]["hlo_flops_per_device"],
            "bytes_per_device": res["roofline"]["hlo_bytes_per_device"],
            "ops": [[name, int(n), f, b] for name, (n, f, b) in ops]}


def diff(a: Dict, b: Dict, top: int = 25, by: str = "flops") -> List[str]:
    """Lines of the ops whose flops (``by="bytes"``: bytes) differ from
    ``a`` to ``b``."""
    col = 1 if by == "flops" else 2
    fa = {e[0]: (e[1], e[1 + col]) for e in a["ops"]}
    fb = {e[0]: (e[1], e[1 + col]) for e in b["ops"]}
    rows = [(fb.get(k, (0, 0.0))[1] - fa.get(k, (0, 0.0))[1], k)
            for k in set(fa) | set(fb)]
    rows = sorted((r for r in rows if r[0]), key=lambda r: -abs(r[0]))
    lines = [f"{by} a device {a[f'{by}_per_device']:.6e} -> "
             f"{b[f'{by}_per_device']:.6e}"]
    for delta, k in rows[:top]:
        lines.append(f"{delta:+.4e}  {fa.get(k, (0, 0))[0]} -> "
                     f"{fb.get(k, (0, 0))[0]} calls  {k}")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"))
    ap.add_argument("--by", choices=("flops", "bytes"), default="flops")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("cell", nargs="*", metavar="ARCH SHAPE OUT")
    args = ap.parse_args(argv)
    if args.diff:
        a, b = (json.load(open(p)) for p in args.diff)
        print("\n".join(diff(a, b, by=args.by)))
        return
    if len(args.cell) != 3:
        ap.error("give ARCH SHAPE OUT.json, or --diff A.json B.json")
    arch, shape, out = args.cell
    res = cell_op_flops(arch, shape, args.layers)
    with open(out, "w") as f:
        json.dump(res, f)
    print(f"{arch} {shape}: {res['status']}, "
          f"{res['flops_per_device']:.6e} flops, "
          f"{res['bytes_per_device']:.6e} bytes a device")


if __name__ == "__main__":
    main()
