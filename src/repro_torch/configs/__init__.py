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
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _jamba
from repro_torch.configs.minicpm_2b import CONFIG as _minicpm
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral
from repro_torch.configs.nemotron_4_15b import CONFIG as _nemotron
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv
from repro_torch.configs.stablelm_1_6b import CONFIG as _stablelm

REGISTRY: Dict[str, ArchConfig] = {
    c.name: c for c in (_stablelm, _deepseek, _minicpm, _nemotron, _olmoe,
                        _mixtral, _rwkv, _jamba)}

# what a later slice brings, by ROADMAP.md Queue 1 item
ROADMAP: Dict[str, str] = {
    "vlm": "ROADMAP.md Queue 1 item 6 (VLM and audio slice)",
    "audio": "ROADMAP.md Queue 1 item 6 (VLM and audio slice)",
}
# archs of the JAX registry the port does not run yet
PENDING: Dict[str, str] = {
    "qwen2-vl-7b": ROADMAP["vlm"], "whisper-small": ROADMAP["audio"],
}


def get_config(name: str) -> ArchConfig:
    if name in REGISTRY:
        return REGISTRY[name]
    if name in PENDING:
        raise KeyError(f"arch {name!r} is not ported yet: {PENDING[name]}")
    raise KeyError(f"unknown arch {name!r}; one of {sorted(REGISTRY)}")
