#!/usr/bin/env python3
"""A port dry-run cell's collectives, summed by the code that issued
them, their kind and their operand's shape.

    PYTHONPATH=src python tools/collective_owners.py ARCH SHAPE [--top N] [--json OUT]

Runs ``repro_torch.launch.dryrun.dryrun_cell(ARCH, SHAPE)`` on the
single-pod (16, 16) mesh under the fake process group, as its costed
rank (train cells on fake CPU tensors on a host with no card, as the
dry run does: a CPU mesh all-gathers where a CUDA mesh does an
all-to-all, so run train cells on the card for the card's figures).
``core.op_cost.CostMode`` records each functional collective; this
tool tags it with its owner: the innermost frame of the model code
(``repro_torch/models``) on the Python stack, prefixed "recompute"
when autograd's engine runs it (an activation checkpoint's forward);
else the autograd node whose backward issued it, or the frame of the
train step (``repro_torch/train``), beside the aten op DTensor was
dispatching.  The dry run's keys
are not changed.  Prints the cell's collective bytes by kind, then the
groups (kind, operand shape, dtype, group size, owner), largest bytes
first; ``--json`` also writes them.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from typing import Dict, Optional

import torch

from repro_torch.core import op_cost
from repro_torch.launch import dryrun as dr

# files whose frames name a collective's owner, innermost first
_OWNERS = ("repro_torch/models/", "repro_torch/train/")


def _owner() -> str:
    """Where the collective being dispatched comes from (see the module
    docstring)."""
    frame, op_call, step = sys._getframe(2), None, None
    node = _node()
    while frame is not None:
        path = frame.f_code.co_filename.replace("\\", "/")
        if op_call is None and path.endswith("tensor/_dispatch.py"):
            op_call = frame.f_locals.get("op_call")
        where = (f"{path.split('repro_torch/', 1)[-1]}:{frame.f_lineno} "
                 f"{frame.f_code.co_name}")
        if _OWNERS[0] in path:
            return ("recompute " if node is not None else "") + where
        if step is None and _OWNERS[1] in path:
            step = where
        frame = frame.f_back
    what = f" [{op_call}]" if op_call is not None else ""
    if node is not None:
        return f"backward of {node.name()}{what}"
    return (step or "step") + what


def _node() -> Optional[object]:
    current = getattr(torch._C, "_current_autograd_node", None)
    return current() if current is not None else None


class _Owners:
    """Patches ``CostMode._move`` while entered: each collective's
    kind, operand shape and dtype, group size and owner."""

    def __init__(self):
        self.groups: Dict[tuple, list] = collections.defaultdict(
            lambda: [0, 0.0])

    def __enter__(self):
        cls = op_cost.CostMode
        self._saved = cls._move
        move = self._saved
        me = self

        def tagged(mode, func, args, out):
            move(mode, func, args, out)
            kind = (op_cost.collective_kind(func)
                    if func.namespace in op_cost.COLLECTIVE_NAMESPACES
                    else None)
            if kind is None:
                return
            operand = op_cost._tensors(args[:1])
            shape = tuple(operand[0].shape) if operand else ()
            dtype = (str(operand[0].dtype).replace("torch.", "")
                     if operand else "?")
            n = op_cost.group_size(func, args, {})
            g = me.groups[(kind, shape, dtype, n, _owner())]
            g[0] += 1
            g[1] += sum(op_cost._nbytes(t) for t in operand)
        cls._move = tagged
        return self

    def __exit__(self, *exc):
        op_cost.CostMode._move = self._saved

    def rows(self):
        return sorted(([kind, list(shape), dtype, n, owner, k, b]
                       for (kind, shape, dtype, n, owner), (k, b)
                       in self.groups.items()), key=lambda r: -r[6])


def collective_owners(arch: str, shape: str) -> Dict:
    """The cell's collectives by kind and by owner."""
    with _Owners() as tr:
        with dr.fake_process_group(256, dr.costed_rank()):
            res = dr.dryrun_cell(arch, shape)
    return {"arch": arch, "shape": shape, "device": res.get("device"),
            "collectives": res.get("collectives", {}),
            "collective_bytes": sum(c["bytes"] for c in
                                    res.get("collectives", {}).values()),
            "memory": res.get("memory"), "owners": tr.rows()}


def show(res: Dict, top: int) -> str:
    lines = [f"{res['arch']} {res['shape']} on {res['device']} tensors: "
             f"collective bytes a device {res['collective_bytes']:.4e}"]
    lines += [f"  {kind}: {c['count']} ops, {c['bytes']:.4e} B"
              for kind, c in sorted(res["collectives"].items())]
    lines += [f"  {b / 1e9:9.3f} GB {k:4d} x {kind} {tuple(shape)} {dtype} "
              f"(group {n}) {owner}"
              for kind, shape, dtype, n, owner, k, b in res["owners"][:top]]
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--top", type=int, default=16)
    ap.add_argument("--json", metavar="OUT")
    args = ap.parse_args(argv)
    res = collective_owners(args.arch, args.shape)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f)
    print(show(res, args.top))


if __name__ == "__main__":
    main()
