#!/usr/bin/env python3
"""Hold the port's production-mesh dry run against the JAX package's,
cell by cell, per device: flops, GB (the step's peak) and collective
bytes, each as JAX's -> the port's with the ratio.

    python -m repro.launch.dryrun --all --single-pod-only --out JAX_DIR
    python -m repro_torch.launch.dryrun --all --single-pod-only --out PORT_DIR
    python tools/compare_dryruns.py JAX_DIR PORT_DIR [--mesh single|multi]

Both dry runs write one ``<arch>__<shape>__<mesh>.json`` a cell.  The JAX
figures are XLA's counts of the module compiled for host CPU devices
(``hlo_cost``), the port's ``op_cost``'s of the ops one rank dispatches;
no time is compared.  A cell that either side did not run ``ok`` is
listed with its status.  Prints a Markdown table.
"""

import argparse
import json
from pathlib import Path


def _load(d: Path, mesh: str) -> dict:
    out = {}
    for p in sorted(d.glob(f"*__*__{mesh}.json")):
        r = json.loads(p.read_text())
        out[(r["arch"], r["shape"])] = r
    return out


def _figures(r: dict):
    ro = r["roofline"]
    return (ro["hlo_flops_per_device"], r["memory"]["per_device_total"] / 1e9,
            ro["collective_bytes_per_device"])


def _pair(a: float, b: float, fmt: str) -> str:
    ratio = f" ({b / a:.2f}×)" if a else ""
    return f"{a:{fmt}} → {b:{fmt}}{ratio}"


def table(jax_dir: Path, port_dir: Path, mesh: str = "single") -> str:
    jax, port = _load(jax_dir, mesh), _load(port_dir, mesh)
    lines = ["| Cell | Flops a device, JAX → port | GB a device, JAX → port "
             "| Collective bytes a device, JAX → port |",
             "|---|---|---|---|"]
    for key in sorted(set(jax) | set(port)):
        j, p = jax.get(key, {}), port.get(key, {})
        if j.get("status") == "skipped" and p.get("status") == "skipped":
            continue
        cell = f"{key[0]} {key[1]}"
        if j.get("status") != "ok" or p.get("status") != "ok":
            lines.append(f"| {cell} | JAX {j.get('status', 'missing')}, port "
                         f"{p.get('status', 'missing')} | | |")
            continue
        (jf, jg, jc), (pf, pg, pc) = _figures(j), _figures(p)
        lines.append(f"| {cell} | {_pair(jf, pf, '.4e')} | "
                     f"{_pair(jg, pg, '.2f')} | {_pair(jc, pc, '.3e')} |")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("jax_dir", type=Path)
    ap.add_argument("port_dir", type=Path)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    args = ap.parse_args()
    print(table(args.jax_dir, args.port_dir, args.mesh))


if __name__ == "__main__":
    main()
