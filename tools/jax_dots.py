#!/usr/bin/env python3
"""Every dot of one JAX dry-run cell's compiled module, with its flops
times its loop trip count, summed by the dot's source op and result
shape.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_dots.py ARCH SHAPE OUT.json
    python tools/jax_dots.py --show OUT.json [--top N]

The first form runs ``repro.launch.dryrun.dryrun_cell(ARCH, SHAPE)`` on
the single-pod (16, 16) mesh of host CPU devices (its own XLA flag; one
cell takes seconds to minutes) and reads the compiled module's HLO text
as ``repro.core.desim.hlo_cost`` counts it: a ``while`` body times its
trip count, fusions and calls recursed, a conditional's costliest
branch.  The dry run itself keeps only the five largest dots.  Each dot
is named by the einsum or op of its ``op_name`` metadata (the last path
component before ``dot_general``, e.g. ``bsd,dhk->bshk``) and its
result's per-device shape.  The JSON has the form of
``repro_torch.launch.op_flops``'s: ``flops_per_device`` (``hlo_cost``'s
total, every op) and ``ops``, ``[name, dots, flops]`` largest first,
``dots`` counting each dot once per trip.  ``--show`` prints a file's
list.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
from typing import Dict, List, Tuple


def dot_name(attrs: str) -> str:
    """The einsum (or op) a dot came from, from its ``op_name``."""
    m = re.search(r'op_name="([^"]*)"', attrs)
    if not m:
        return "dot"
    parts = [p for p in m.group(1).split("/") if p]
    eins = [p for p in parts if "->" in p]
    if eins:
        return eins[-1]
    parts = [p for p in parts if p not in ("dot_general", "dot")]
    return parts[-1] if parts else "dot"


def module_dots(hlo_text: str) -> Tuple[float, List]:
    """(hlo_cost's flops of the module, [[name, dots, flops], ...])."""
    from repro.core.desim.hlo_cost import HloCostModel
    model = HloCostModel(hlo_text)
    sums: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0.0])

    def walk(name: str, mult: float, seen: Tuple[str, ...]) -> None:
        comp = model.comps.get(name)
        if comp is None or name in seen:
            return
        seen = seen + (name,)
        types = dict(comp.param_types)
        for ins in comp.instrs:
            types[ins.name] = ins.out_type
            op = ins.opcode
            if op == "while":
                bm = re.search(r"body=%?([\w.\-]+)", ins.attrs)
                cm = re.search(r"condition=%?([\w.\-]+)", ins.attrs)
                ktc = re.search(r"known_trip_count[^0-9]*(\d+)", ins.raw)
                trips = (int(ktc.group(1)) if ktc else
                         model.trip_count(cm.group(1)) if cm else 1)
                if bm:
                    walk(bm.group(1), mult * trips, seen)
            elif op in ("call", "async-start", "fusion"):
                cm = re.search(r"(?:calls|called_computation)=%?([\w.\-]+)",
                               ins.attrs)
                if cm:
                    walk(cm.group(1), mult, seen)
            elif op == "conditional":
                br = re.findall(r"branch_computations=\{([^}]*)\}",
                                ins.attrs)
                names = re.findall(r"%([\w.\-]+)", br[0]) if br else []
                if names:
                    walk(max(names, key=lambda n: model.comp_cost(
                        n, True).flops), mult, seen)
            elif op == "dot":
                flops = model._dot_flops(ins, types)
                shape = re.sub(r"\{[^}]*\}", "", ins.out_type)
                entry = sums[f"{dot_name(ins.attrs)} {shape}"]
                entry[0] += mult
                entry[1] += flops * mult

    walk(model.entry, 1.0, ())
    total = model.analyze().flops
    ops = sorted(([k, int(n), f] for k, (n, f) in sums.items()),
                 key=lambda r: -r[2])
    return total, ops


def cell_dots(arch: str, shape: str) -> Dict:
    """The cell's flops a device and its dots, from its compiled HLO."""
    import repro.launch.dryrun as jd
    captured = {}
    analyze = jd.analyze_hlo

    def keep(text):
        captured["hlo"] = text
        return analyze(text)
    jd.analyze_hlo = keep
    try:
        res = jd.dryrun_cell(arch, shape)
    finally:
        jd.analyze_hlo = analyze
    if res["status"] != "ok":
        return {"arch": arch, "shape": shape, "status": res["status"],
                "flops_per_device": 0.0, "ops": []}
    total, ops = module_dots(captured["hlo"])
    return {"arch": arch, "shape": shape, "status": res["status"],
            "flops_per_device": total, "ops": ops}


def show(res: Dict, top: int) -> str:
    dots = sum(f for _, _, f in res["ops"])
    lines = [f"{res['arch']} {res['shape']}: {res['flops_per_device']:.6e} "
             f"flops a device, {dots:.6e} in dots"]
    lines += [f"{f:.4e}  {n:6d}  {name}" for name, n, f in res["ops"][:top]]
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--show", metavar="OUT.json")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("cell", nargs="*", metavar="ARCH SHAPE OUT")
    args = ap.parse_args(argv)
    if args.show:
        with open(args.show) as f:
            print(show(json.load(f), args.top))
        return
    if len(args.cell) != 3:
        ap.error("give ARCH SHAPE OUT.json, or --show OUT.json")
    arch, shape, out = args.cell
    res = cell_dots(arch, shape)
    with open(out, "w") as f:
        json.dump(res, f)
    print(show(res, args.top))


if __name__ == "__main__":
    main()
