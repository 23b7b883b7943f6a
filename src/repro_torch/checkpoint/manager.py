"""Atomic, async checkpointing of the port, as ``repro.checkpoint.manager``.

The on-disk format is the JAX package's, so that each package restores
the other's checkpoints:

* ``<dir>/step_%08d``, written as ``step_%08d.tmp`` and renamed when
  complete: a crash mid-save never leaves a half checkpoint under a
  published name.
* One ``.npy`` per leaf, named by its key with ``/`` -> ``__``; the key
  joins the leaf's path as JAX's ``tree_flatten_with_path`` does (a dict
  entry adds its key, a tuple entry its index: ``params/layers/0/ffn/wg``
  for a hybrid arch).
* ``manifest.json``: ``step``, ``leaves`` (``file``, ``shape`` and
  ``dtype`` of each key), ``extra`` and ``treedef``, the tree's shape
  written as ``jax.tree.structure`` prints it (no reader needs it).
* ``keep_n``: older steps are pruned after a publish, never the newest.

``save()`` returns once every leaf is copied to host memory: the port's
AdamW updates params and moments in place, so the next step must not
change what the background thread is still writing.  The write runs on
a thread; an exception there is parked and raised by the next ``wait()``
or ``save()``.

bf16 leaves need no ``ml_dtypes``: a bf16 leaf is written as its 16-bit
payload in a 2-byte void array (the bytes numpy writes for an ml_dtypes
``bfloat16`` array) with the dtype ``bfloat16`` in the manifest, and such
a file is read back as ``uint16`` bits viewed as ``torch.bfloat16``.
Other casts into the target's dtype follow numpy's ``astype`` (f32 to
bf16 rounds to nearest even, as ``Tensor.to`` does).

A state distributed on a device mesh (DTensor leaves) is saved as its
global arrays: every rank gathers each leaf (``full_tensor``), rank 0
writes, and the others wait for its publish in the next ``wait()``,
where a failed write raises on every rank; the files are the bytes an
unsharded save of the same state writes.
``restore(..., shardings=...)`` reads the global arrays and places each
leaf by its ``NamedSharding`` (``repro_torch.dist.sharding``) with
``distribute_tensor``, each rank taking its shard of the array it read:
a checkpoint written on any mesh, or by the JAX package, restores onto
any other.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.sharding import NamedSharding
from repro_torch.models.common import (TensorSpec, leaves, leaves_with_path,
                                       unflatten)

BF16 = "bfloat16"


def _snapshot(leaf: torch.Tensor) -> torch.Tensor:
    """A host copy of ``leaf`` that later in-place updates cannot reach:
    a blocking copy off the card, a clone on the CPU (``.numpy()`` of a
    CPU tensor shares its memory).  A DTensor's global array, gathered
    from every rank (each rank must call this)."""
    x = leaf.detach()
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.clone() if x.device.type == "cpu" else x.to("cpu")


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.dtype("V2"))
    return x.numpy()


def _from_file(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == BF16:
        if arr.dtype.itemsize != 2:
            raise ValueError(f"{path}: {arr.dtype} on disk, manifest says "
                             f"bfloat16")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _treedef(tree: Any) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if type(tree) is tuple:
        inner = ", ".join(_treedef(t) for t in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self.saves = 0
        self.save_seconds = 0.0         # background writes, published saves
        self.snapshot_seconds = 0.0     # save()'s foreground copies to host
        self._shared = False            # a distributed save is in flight
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, state: Any, step: int, extra: Optional[Dict] = None
             ) -> str:
        self.wait()
        t0 = time.perf_counter()
        host = [(k, _snapshot(x)) for k, x in leaves_with_path(state)]
        self.snapshot_seconds += time.perf_counter() - t0
        treedef = f"PyTreeDef({_treedef(state)})"
        final = os.path.join(self.dir, f"step_{step:08d}")
        self._shared = any(isinstance(x, DTensor) for x in leaves(state))
        if self._shared and dist.get_rank() != 0:
            if not self.async_save:
                self.wait()                    # rank 0's outcome
            return final                       # rank 0 writes

        def _write():
            t0 = time.perf_counter()
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": {}, "extra": extra or {},
                        "treedef": treedef}
            for key, leaf in host:
                fname = key.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fname), _to_numpy(leaf))
                manifest["leaves"][key] = {
                    "file": fname, "shape": list(leaf.shape),
                    "dtype": str(leaf.dtype).split(".")[-1]}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)              # atomic publish
            self._prune()
            self.saves += 1
            self.save_seconds += time.perf_counter() - t0

        def _write_parked():
            # a failed save must not be silent: park the exception and
            # re-raise it on the next wait()/save()
            try:
                _write()
            except BaseException as e:         # noqa: BLE001
                self._exc = e

        if self.async_save:
            self._thread = threading.Thread(target=_write_parked,
                                            daemon=True)
            self._thread.start()
        elif self._shared:
            _write_parked()
            self.wait()
        else:
            _write()
        return final

    def wait(self) -> None:
        """Join the in-flight async save.  If it failed, the exception
        is re-raised here (a silently lost checkpoint would surface only
        at restore time, after the data is gone).  After a distributed
        save every rank waits here until rank 0 has published it or
        failed to, and then raises on every rank if it failed (the ranks
        meet in one collective, so a lost checkpoint never leaves the
        others waiting for rank 0)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        exc, self._exc = self._exc, None
        if self._shared:
            self._shared = False
            failed = [None if exc is None
                      else f"{type(exc).__name__}: {exc}"]
            dist.broadcast_object_list(failed, src=0)
            if exc is None and failed[0] is not None:
                raise RuntimeError(f"rank 0 failed to write the "
                                   f"checkpoint: {failed[0]}")
        if exc is not None:
            raise exc

    def _prune(self) -> None:
        steps = self.available_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def available_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: Optional[int] = None,
                shardings: Any = None, device: DeviceLike = None) -> Any:
        """Restore into the structure of ``target``, a tree of tensors or
        of ``TensorSpec``s: new tensors in each target leaf's dtype, on a
        tensor leaf's device (a spec's go to ``device``: ``cuda`` unless
        the caller passes ``cpu``), requiring grad where the target leaf
        does.  The latest step unless ``step`` is given.

        ``shardings``, a tree of ``NamedSharding``s congruent with
        ``target``, puts each leaf on its sharding's mesh with its
        placements instead (a DTensor; every rank reads the global array
        and keeps its own shard, with no communication)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)

        places = (None if shardings is None
                  else iter(list(leaves(shardings))))
        spec_device = None
        out = []
        for key, leaf in leaves_with_path(target):
            info = manifest["leaves"][key]
            t = _from_file(os.path.join(d, info["file"]), info["dtype"])
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {tuple(t.shape)} in step "
                                 f"{step}, target {tuple(leaf.shape)}")
            if places is not None:
                s = next(places)
                if not isinstance(s, NamedSharding):
                    raise TypeError(f"{key}: shardings hold a "
                                    f"{type(s).__name__}, want a "
                                    f"NamedSharding (repro_torch.dist."
                                    f"sharding)")
                t = distribute_tensor(t.to(dtype=leaf.dtype), s.mesh,
                                      s.placements, src_data_rank=None)
            else:
                if isinstance(leaf, TensorSpec):
                    if spec_device is None:
                        spec_device = resolve_device(device)
                    dev = spec_device
                else:
                    dev = leaf.device
                t = t.to(device=dev, dtype=leaf.dtype)
            if leaf.requires_grad:
                t.requires_grad_(True)
            out.append(t)
        return unflatten(target, out)
