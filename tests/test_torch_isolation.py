"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import no
JAX and nothing of the ``repro`` package, and their entry points run on
the GPU unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "repro"
             or n.startswith("repro."))
print("IMPORTED", len([n for n in sys.modules if n.startswith("repro_torch")]))
print("BAD", bad)
"""


def test_importing_the_port_loads_no_jax_and_no_repro():
    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n = int(out.stdout.split("IMPORTED")[1].split()[0])
    assert n >= 20, out.stdout          # every module of the port loaded


BLOCKED = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import repro_torch.core.fidelity, repro_torch.core.op_cost
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.moe_mlp import ops
from repro_torch.kernels.quantize import ops
from repro_torch.kernels.rwkv6_wkv import ops
print("OK", sorted(n for n in sys.modules if n.startswith("repro_torch.core")))
"""


def test_fidelity_and_kernel_ops_import_with_jax_and_repro_blocked():
    """The fidelity layer and the kernels' custom ops import with every
    import of ``jax`` and ``repro`` made to fail."""
    out = subprocess.run(
        [sys.executable, "-c", BLOCKED], capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert ("OK ['repro_torch.core', 'repro_torch.core.fidelity', "
            "'repro_torch.core.op_cost']") in out.stdout, out.stdout


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_source_has_no_jax_or_repro_import(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")


def test_entry_points_raise_without_a_card_unless_cpu():
    _no_card()
    from repro_torch.configs import get_config, smoke
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import build_model
    from repro_torch.serve import BatchServer

    model = build_model(smoke(get_config("stablelm-1.6b")), torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 8)
    params = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchServer(model, params, slots=1, seq_capacity=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--requests", "1"])
    srv = BatchServer(model, params, slots=1, seq_capacity=8, device="cpu")
    from repro_torch.serve import Request
    done = srv.serve([Request(0, np.array([1, 2]), max_new_tokens=2)])
    assert len(done[0].output) == 2


def test_launcher_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--requests", "2", "--slots", "2", "--max-new", "3",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "req 0:" in out and "req 1:" in out
    assert "server.requests 2" in out


def test_launcher_serves_olmoe_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", "olmoe-1b-7b", "--requests", "3",
                       "--max-new", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "req 2:" in out and "server.requests 3" in out


def test_launcher_serves_rwkv_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", "rwkv6-7b", "--requests", "3",
                       "--max-new", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "req 2:" in out and "server.requests 3" in out


def test_moe_archs_resolve_in_the_port():
    from repro_torch.configs import get_config
    for name in ("olmoe-1b-7b", "mixtral-8x22b"):
        cfg = get_config(name)
        assert cfg.family == "moe" and cfg.act == "swiglu"


def test_launcher_serves_jamba_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", "jamba-v0.1-52b", "--requests", "3",
                       "--max-new", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "req 2:" in out and "server.requests 3" in out


def test_unported_archs_and_families_name_their_roadmap_item():
    """No arch is left unported: every name of the JAX registry resolves
    in the port, to its family; an unknown arch or family raises."""
    from dataclasses import replace
    from repro.configs import REGISTRY as JAX_REGISTRY
    from repro_torch.configs import REGISTRY, get_config
    from repro_torch.models import build_model
    assert sorted(REGISTRY) == sorted(JAX_REGISTRY)
    for name, want in JAX_REGISTRY.items():
        cfg = get_config(name)
        assert cfg.family == want.family
        assert build_model(cfg).cfg is cfg
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    with pytest.raises(ValueError, match="family 'speech'"):
        build_model(replace(get_config("stablelm-1.6b"), family="speech"))
    assert get_config("jamba-v0.1-52b").family == "hybrid"
    assert get_config("qwen2-vl-7b").family == "vlm"
    assert get_config("whisper-small").family == "audio"


def test_launcher_serves_qwen2_vl_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", "qwen2-vl-7b", "--requests", "3",
                       "--max-new", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "req 2:" in out and "server.requests 3" in out


def test_config_copies_match_the_jax_package():
    import dataclasses
    from repro.configs import get_config as jax_get_config
    from repro.configs import smoke as jax_smoke
    from repro_torch.configs import REGISTRY, smoke
    for name, cfg in REGISTRY.items():
        want = jax_get_config(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
        assert dataclasses.asdict(smoke(cfg)) == \
            dataclasses.asdict(jax_smoke(want))


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    _no_card()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, timeout=120, env=env, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


PURE_COPIES = ["core/stats.py", "core/simobject.py", "train/ft.py",
               "train/ft_policy.py"]


def _body(path: Path) -> str:
    """The source below the module docstring, with ``repro.`` ->
    ``repro_torch.`` in its import lines."""
    text = path.read_text()
    doc = ast.parse(text).body[0]
    assert isinstance(doc, ast.Expr) and isinstance(doc.value, ast.Constant)
    lines = text.splitlines()[doc.end_lineno:]
    return "\n".join(
        ln.replace("from repro.", "from repro_torch.")
        .replace("import repro.", "import repro_torch.")
        if ln.lstrip().startswith(("from repro.", "import repro.")) else ln
        for ln in lines)


@pytest.mark.parametrize("rel", PURE_COPIES)
def test_pure_copies_equal_their_originals(rel):
    """The port's copies of the pure modules the Trainer needs equal the
    JAX package's source line for line; the one permitted difference is
    the module docstring, which names the copy."""
    copy, orig = PORT / rel, ROOT / "src" / "repro" / rel
    assert _body(copy) == _body(orig)
    mod = rel[:-3].replace("/", ".")
    assert f"A copy of ``repro.{mod}``" in ast.get_docstring(
        ast.parse(copy.read_text()))


TRAINER_BLOCKED = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import repro_torch.checkpoint, repro_torch.train.trainer
from repro_torch.train import Trainer, FTPolicy, SimulatedFailure
print("OK", sorted(n for n in sys.modules
                   if n.startswith(("repro_torch.checkpoint",
                                    "repro_torch.train"))))
"""


def test_checkpoint_and_trainer_import_with_jax_and_repro_blocked():
    out = subprocess.run(
        [sys.executable, "-c", TRAINER_BLOCKED], capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert ("OK ['repro_torch.checkpoint', 'repro_torch.checkpoint.manager', "
            "'repro_torch.train', 'repro_torch.train.ft', "
            "'repro_torch.train.ft_policy', 'repro_torch.train.step', "
            "'repro_torch.train.trainer']") in out.stdout, out.stdout


def test_trainer_on_the_default_device_raises_without_a_card(tmp_path):
    """The Trainer runs where its state lies; a state, a launcher run or
    a restore into specs on the default device needs the card."""
    _no_card()
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, smoke
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.models.common import TensorSpec
    from repro_torch.train import TrainOptions, init_train_state
    model = build_model(smoke(get_config("stablelm-1.6b")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(model, 0, TrainOptions())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save({"w": torch.ones(2)}, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore({"w": TensorSpec((2,), torch.float32)})


MESH_BLOCKED = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import torch.distributed as dist
import repro_torch.dist.sharding, repro_torch.launch.mesh
print("OK", dist.is_initialized(),
      any("fake_pg" in n for n in sys.modules))
"""


def test_sharding_and_mesh_import_with_no_process_group():
    """``dist/sharding.py`` and ``launch/mesh.py`` import with ``jax`` and
    ``repro`` blocked, create no process group and load no fake one."""
    out = subprocess.run(
        [sys.executable, "-c", MESH_BLOCKED], capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "OK False False" in out.stdout, out.stdout


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_fake_process_group_is_imported_only_inside_functions(path):
    """PyTorch's fake process group (a testing module) is never imported
    at a module's top level: importing the port must not load it."""
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any("fake_pg" in n or "_internal" in n for n in names), (
            path, names)
