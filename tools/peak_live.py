#!/usr/bin/env python3
"""The storage alive at a port dry-run cell's peak, by the op that made
it, its shape and dtype.

    PYTHONPATH=src python tools/peak_live.py ARCH SHAPE [--top N] [--json OUT]
    PYTHONPATH=src python tools/peak_live.py ARCH SHAPE --batch B

The first form runs ``repro_torch.launch.dryrun.dryrun_cell(ARCH,
SHAPE)`` on the single-pod (16, 16) mesh under the fake process group,
as its costed rank (train cells on fake CPU tensors on a host with no
card, as the dry run does); the second runs the cell cut to a global
batch of B on the (1, 1) mesh of a one-rank fake group, on fake CUDA
tensors (``chip_smoke.py`` phase 22's cells).  ``core.op_cost.CostMode``
tags each storage an op creates with the op's index, name, shape and
dtype; at each new peak of the live storage the live set is kept.  The
dry run's keys are not changed.  Prints the cell's memory, the op at
the peak and the live storage grouped by (op, shape, dtype), largest
first; ``--json`` also writes them.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
from typing import Dict

from repro_torch.core import op_cost
from repro_torch.core.fidelity import DryRunBackend
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_mesh


class _PeakLive:
    """Patches ``CostMode`` while it is entered: each created storage's
    tag, and the live set at the highest peak."""

    def __init__(self):
        self.tags: Dict[int, tuple] = {}
        self.n_ops, self.peak = 0, 0.0
        self.at, self.live = None, {}
        self._op = None

    def __enter__(self):
        cls = op_cost.CostMode
        self._saved = cls.__torch_dispatch__, cls._track
        dispatch, track = self._saved
        me = self

        def counted(mode, func, types, args=(), kwargs=None):
            me._op = str(func)
            me.n_ops += 1
            return dispatch(mode, func, types, args, kwargs)

        def tagged(mode, out):
            before = set(mode.created)
            track(mode, out)
            for t in op_cost._tensors(out):
                key = id(t.untyped_storage())
                if key in mode.created and key not in before:
                    me.tags[key] = (me._op, tuple(t.shape),
                                    str(t.dtype).replace("torch.", ""))
            if mode.live_bytes > me.peak:
                me.peak, me.at = mode.live_bytes, (me.n_ops, me._op)
                me.live = {k: (n, me.tags.get(k))
                           for k, n in mode.created.items()}
        cls.__torch_dispatch__, cls._track = counted, tagged
        return self

    def __exit__(self, *exc):
        cls = op_cost.CostMode
        cls.__torch_dispatch__, cls._track = self._saved

    def groups(self):
        out = collections.defaultdict(lambda: [0, 0.0])
        for n, tag in self.live.values():
            g = out[tag or ("?", (), "?")]
            g[0] += 1
            g[1] += n
        return sorted(([op, list(shape), dtype, k, b]
                       for (op, shape, dtype), (k, b) in out.items()),
                      key=lambda r: -r[4])


def peak_live(arch: str, shape: str, batch: int = 0) -> Dict:
    """The cell's memory and its live storage at the peak."""
    with _PeakLive() as tr:
        if batch:
            with dr.fake_process_group(1, 0):
                mesh = make_mesh((1, 1), ("data", "model"), "cuda")
                cut = dataclasses.replace(dr.SHAPES[shape],
                                          global_batch=batch)
                prog, _, _ = dr.build_program(arch, shape, mesh,
                                              device="cuda", shape=cut)
                mem = dict(DryRunBackend().run(prog).memory)
        else:
            with dr.fake_process_group(256, dr.costed_rank()):
                mem = dr.dryrun_cell(arch, shape)["memory"]
    return {"arch": arch, "shape": shape, "batch": batch or None,
            "memory": mem, "peak_created_bytes": tr.peak,
            "peak_op": list(tr.at), "n_ops": tr.n_ops,
            "live": tr.groups()}


def show(res: Dict, top: int) -> str:
    mem = {k: round(v / 1e9, 3) for k, v in res["memory"].items()}
    n, op = res["peak_op"]
    lines = [f"{res['arch']} {res['shape']}"
             + (f" at batch {res['batch']}" if res["batch"] else "")
             + f": memory GB {mem}",
             f"storage created by the step at its peak: "
             f"{res['peak_created_bytes'] / 1e9:.3f} GB, at op {n} of "
             f"{res['n_ops']} ({op})"]
    lines += [f"  {b / 1e9:9.3f} GB  {k:4d} x  {op} {tuple(shape)} {dtype}"
              for op, shape, dtype, k, b in res["live"][:top]]
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--batch", type=int, default=0,
                    help="cut the cell to this global batch, on the (1, 1) "
                         "mesh")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--json", metavar="OUT")
    args = ap.parse_args(argv)
    res = peak_live(args.arch, args.shape, args.batch)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f)
    print(show(res, args.top))


if __name__ == "__main__":
    main()
