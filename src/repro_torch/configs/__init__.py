"""Architecture registry of the port (``--arch <id>`` resolution).

Lists only the archs the port can run.  Every other arch of the JAX
package's registry raises ``KeyError`` naming the ROADMAP item that
brings it.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, ShapeConfig, SHAPES, smoke, smoke_shape,
)
from repro_torch.configs.deepseek_67b import CONFIG as _deepseek
from repro_torch.configs.stablelm_1_6b import CONFIG as _stablelm

REGISTRY: Dict[str, ArchConfig] = {c.name: c for c in (_stablelm, _deepseek)}

# what a later slice brings, by ROADMAP.md Queue 1 item
ROADMAP: Dict[str, str] = {
    "train": "ROADMAP.md Queue 1 item 1 (training slice)",
    "moe": "ROADMAP.md Queue 1 item 2 (MoE slice with moe_mlp)",
    "ssm": "ROADMAP.md Queue 1 item 4 (RWKV slice with rwkv6_wkv)",
    "hybrid": "ROADMAP.md Queue 1 item 5 (Mamba and hybrid slice)",
    "vlm": "ROADMAP.md Queue 1 item 6 (VLM and audio slice)",
    "audio": "ROADMAP.md Queue 1 item 6 (VLM and audio slice)",
}
# archs of the JAX registry the port does not run yet
PENDING: Dict[str, str] = {
    "minicpm-2b": ROADMAP["train"], "nemotron-4-15b": ROADMAP["train"],
    "olmoe-1b-7b": ROADMAP["moe"], "mixtral-8x22b": ROADMAP["moe"],
    "rwkv6-7b": ROADMAP["ssm"], "jamba-v0.1-52b": ROADMAP["hybrid"],
    "qwen2-vl-7b": ROADMAP["vlm"], "whisper-small": ROADMAP["audio"],
}


def get_config(name: str) -> ArchConfig:
    if name in REGISTRY:
        return REGISTRY[name]
    if name in PENDING:
        raise KeyError(f"arch {name!r} is not ported yet: {PENDING[name]}")
    raise KeyError(f"unknown arch {name!r}; one of {sorted(REGISTRY)}")
