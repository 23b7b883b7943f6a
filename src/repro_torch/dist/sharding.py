"""Logical-axis sharding of the port on PyTorch's ``DeviceMesh`` and
``DTensor``, the twin of ``repro.dist.sharding``.

Every parameter and activation carries *logical* axes ("embed", "mlp",
"heads", ...; ``repro_torch.models.common.param``), and this module owns
the one mapping from logical axes to *mesh* axes:

* ``make_rules(cfg, shape, mesh)`` derives the :class:`Rules` of one
  (architecture x input shape x mesh) cell with the JAX package's
  fallback ladder (heads that do not divide the model axis fall back to
  context parallelism, GQA kv heads to kv-sequence sharding for decode,
  a batch that does not divide the data-parallel ranks stays unsharded).
* ``Rules.spec(logical_axes)`` resolves a tuple of logical names to a
  :class:`PartitionSpec` (a mesh axis shards at most one dim), and
  ``Rules.placements(spec, mesh)`` turns a spec into DTensor placements,
  one per mesh dim.
* :class:`MeshSharder` is the ``Sharder`` the model code calls on a mesh:
  ``ac`` redistributes an activation to its spec, and it builds the
  placements of parameter and batch trees and puts trees on the mesh.

The JAX package's terms map onto PyTorch's as

    with_sharding_constraint        DTensor.redistribute
    NamedSharding / PartitionSpec   NamedSharding(mesh, placements), one
                                    Shard(d) or Replicate() per mesh dim
    jax.make_mesh                   init_device_mesh (launch/mesh.py)
    device_put(arr, sharding)       distribute_tensor

``Rules`` and ``make_rules`` read nothing but axis names and sizes, so a
mock mesh serves them (a ``DeviceMesh``, or anything with ``axis_names``
and ``devices.shape`` as the JAX package's tests build).  Nothing here
creates a process group.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.common import (Sharder, contiguous_strides,
                                       local_shape_and_offset, map_leaves)

# logical axis name -> tuple of mesh axis names (None = replicated)
Mapping = Dict[str, Optional[Tuple[str, ...]]]


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of them (the dim split over those axes, major to minor),
    as ``jax.sharding.PartitionSpec``.  A leaf of the port's tree walks."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class NamedSharding(NamedTuple):
    """A tensor's layout on ``mesh``: its DTensor ``placements``, one per
    mesh dim (``jax.sharding.NamedSharding``)."""
    mesh: Any
    placements: Tuple[Placement, ...]


def mesh_axes(mesh: Any) -> Dict[str, int]:
    """Axis name -> size, in mesh order, of a ``DeviceMesh`` or of a mock
    with ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


@dataclass
class Rules:
    """Logical-axis -> mesh-axis mapping for one cell."""

    mapping: Mapping = field(default_factory=dict)
    axis_sizes: Dict[str, int] = field(default_factory=dict)

    def spec(self, logical_axes: Tuple[Optional[str], ...]) -> PartitionSpec:
        """PartitionSpec for a tuple of logical axis names.  A mesh axis
        shards at most one dim: later uses of an axis already taken are
        dropped (replicated), so every spec is valid."""
        used: set = set()
        entries = []
        for name in logical_axes:
            mesh_axes_ = self.mapping.get(name) if name else None
            if mesh_axes_:
                mesh_axes_ = tuple(a for a in mesh_axes_ if a not in used)
            if not mesh_axes_:
                entries.append(None)
                continue
            used.update(mesh_axes_)
            entries.append(mesh_axes_[0] if len(mesh_axes_) == 1
                           else tuple(mesh_axes_))
        return PartitionSpec(*entries)

    def size(self, logical: str) -> int:
        """Number of shards a logical axis is split into."""
        mesh_axes_ = self.mapping.get(logical)
        if not mesh_axes_:
            return 1
        return math.prod(self.axis_sizes.get(a, 1) for a in mesh_axes_)

    def describe(self) -> Dict[str, Any]:
        return {k: (list(v) if v else None) for k, v in self.mapping.items()}

    def placements(self, spec: PartitionSpec, mesh: Any
                   ) -> Tuple[Placement, ...]:
        """The DTensor placements of ``spec`` on ``mesh``, one per mesh
        dim: ``Shard(d)`` on each mesh dim that an entry of tensor dim d
        names, ``Replicate()`` on the others.  A tuple entry splits its
        dim over several mesh dims; DTensor splits in mesh order, so the
        entry must list them in mesh order (JAX's major to minor), and
        anything else raises, as does an axis the mesh does not have.
        A mesh dim of size 1 splits nothing: its placement is
        ``Replicate()`` (a JAX axis of size 1 is the same layout), which
        also keeps DTensor from refusing views that merge two dims split
        over two mesh dims of size 1 (torch 2.11's batched matmuls)."""
        sizes = mesh_axes(mesh)
        names = list(sizes)
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            missing = [a for a in axes if a not in names]
            if missing:
                raise ValueError(f"spec {spec} names mesh axes {missing} "
                                 f"not in the mesh's {names}")
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"spec {spec}: dim {dim} is split over "
                                 f"{axes}, not in the mesh's order {names}; "
                                 f"DTensor splits a dim in mesh order")
            for i in idx:
                if sizes[names[i]] > 1:
                    out[i] = Shard(dim)
        return tuple(out)


def make_rules(cfg: ArchConfig, shape: ShapeConfig, mesh: Any) -> Rules:
    """Derive the sharding rules for one (arch x shape x mesh) cell.

    Fallback ladder (each rung used only when the one above does not
    divide the mesh axis):

    * attention heads  : TP over "model"  -> context parallel ("q_seq")
    * GQA kv heads     : TP over "model"  -> kv-cache sequence sharding
                         ("kv_seq", decode only; capacity is the
                         sliding window when the arch has one)
    * batch            : hierarchical DP over ("pod", "data") -> None
                         when the global batch does not divide the DP
                         ranks (e.g. long_500k batch=1)
    """
    sizes = mesh_axes(mesh)
    model = sizes.get("model", 1)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp = math.prod(sizes[a] for a in dp_axes) if dp_axes else 1

    def fits(n: int) -> bool:
        return n > 0 and n % model == 0

    heads_tp = fits(cfg.n_heads)
    kv_tp = fits(cfg.n_kv_heads)

    # decode kv-cache capacity: sliding-window archs cap the cache
    cache_len = shape.seq_len
    if cfg.sliding_window:
        cache_len = min(cache_len, cfg.sliding_window)

    mapping: Mapping = {
        "batch": (dp_axes if dp_axes and shape.global_batch % dp == 0
                  else None),
        "seq": None,
        "embed": None,
        "mlp": ("model",) if fits(cfg.d_ff) else None,
        "heads": ("model",) if heads_tp else None,
        "kv_heads": ("model",) if kv_tp else None,
        "kv_heads_c": ("model",) if kv_tp else None,
        "vocab": ("model",) if fits(cfg.vocab_size) else None,
        # context parallelism replaces head TP when heads don't divide
        "q_seq": (("model",) if not heads_tp and fits(shape.seq_len)
                  else None),
        # kv-cache sequence sharding replaces kv-head TP for decode
        "kv_seq": (("model",) if shape.kind == "decode" and not kv_tp
                   and fits(cache_len) else None),
        "experts": ("model",) if fits(cfg.n_experts) else None,
    }
    return Rules(mapping=mapping, axis_sizes=sizes)


class _LayOutCotangent(torch.autograd.Function):
    """The identity on a DTensor laid out by ``placements``, whose
    backward reduces a cotangent that arrives as a partial sum to that
    layout, as JAX's constraint on the cotangent (the transpose of
    ``with_sharding_constraint``) reduces it there.  Without it the sum
    stays pending into the ops before (the unembedding's x gradient,
    summed over "model" from logits split over the vocab), and DTensor
    gathers a split weight whole for them (the last MLP's down
    projection over the whole d_ff).  A cotangent with no pending sum
    keeps the layout it arrives in, and each rank's ops keep to its
    shard: laying a split one out as the constraint would (a gather
    where the activation is replicated) costs olmoe-1b-7b's train_4k
    cell 15% more flops a device on the card."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and any(p.is_partial()
                                          for p in g.placements):
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g, None, None


class _Home(NamedTuple):
    """Where a slice that ``MeshSharder.decode_layer`` moved came from:
    ``layer``, the layer's local slice of the stacked leaf on the rank
    that holds it (None on the others); ``dims``, the mesh dims that
    split the leaf's layers; ``split``, whether the moved slice splits
    the batch over them (else it is the whole layer on each);
    ``owner``, the holder's index along ``dims``; ``n``, the ranks along
    them."""
    layer: Optional[torch.Tensor]
    dims: Tuple[int, ...]
    split: bool
    owner: int
    n: int


class MeshSharder(Sharder):
    """``Sharder`` that applies the rules on a ``DeviceMesh``.

    ``ac`` makes a plain tensor a replicated DTensor (the model's own
    tensors, identical on every rank) and redistributes a DTensor to the
    placements of its logical axes; a gradient that reaches it as a
    partial sum is reduced to the same placements
    (``_LayOutCotangent``).  ``scope()`` is
    ``implicit_replication()``: inside it the plain tensors the model
    makes (positions, masks, RoPE tables, arange indices) meet the
    distributed ones as replicated DTensors."""

    def __init__(self, mesh: Any, rules: Rules):
        self.mesh = mesh
        self.rules = rules
        self._placements: Dict[Tuple, Tuple[Placement, ...]] = {}
        self._depth = 0                 # scope() nesting
        self._groups: Dict[Tuple[int, ...], Any] = {}
        dp = tuple(i for i, a in enumerate(getattr(mesh, "mesh_dim_names",
                                                   None) or ())
                   if a in (rules.mapping.get("batch") or ())
                   and mesh.size(i) > 1)
        if len(dp) > 1:
            # the group of the data-parallel ranks, which split a decode
            # cache's layers (``decode_layer``), made here: flattening a
            # mesh inside a step's fake-tensor mode fails (a mock mesh,
            # which the rules' tests give, has no dim names)
            self._group(dp)
        # each slice ``decode_layer`` moved -> where its layer lives
        self._homes = WeakIdKeyDictionary()

    # -- Sharder interface ------------------------------------------------
    def ac(self, x: torch.Tensor, axes: Tuple[Optional[str], ...]
           ) -> torch.Tensor:
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.mesh,
                                   [Replicate()] * self.mesh.ndim,
                                   run_check=False)
        if x.ndim != len(axes):
            return x
        key = (tuple(x.shape), tuple(axes))
        want = self._placements.get(key)
        if want is None:
            want = self.rules.placements(
                self._spec_for_shape(x.shape, axes), self.mesh)
            self._placements[key] = want
        if x.device_mesh is not self.mesh:
            # an equal mesh of an earlier process group (DTensor's
            # propagation cache hands out the first of equal meshes): its
            # coordinate is another rank's, which code that reads the
            # rank's place (``flash_attention_rows``) must not see
            x = DTensor.from_local(x.to_local(), self.mesh, x.placements,
                                   run_check=False, shape=x.shape,
                                   stride=x.stride())
        if tuple(x.placements) != want:
            y = x.redistribute(self.mesh, want)
            local = y.to_local()
            if local.is_contiguous() and y.is_contiguous():
                x = y
            else:
                # redistribute keeps the input's global strides; when
                # those and the new local shard's layout disagree (an
                # einsum output's permuted strides), a later view on the
                # shard fails: give the result a contiguous shard and
                # contiguous global strides
                x = DTensor.from_local(local.contiguous(), self.mesh, want,
                                       run_check=False, shape=y.shape,
                                       stride=contiguous_strides(y.shape))
        if x.requires_grad and torch.is_grad_enabled():
            x = _LayOutCotangent.apply(x, self.mesh, want)
        return x

    def axis_size(self, logical: str) -> int:
        return self.rules.size(logical)

    @contextlib.contextmanager
    def scope(self) -> Iterator[None]:
        """``implicit_replication()`` around the outermost scope entered
        (a train step around its model call): that context resets its
        flag on exit, so an inner scope leaves the flag to the outer."""
        self._depth += 1
        try:
            if self._depth > 1:
                yield
            else:
                with implicit_replication():
                    yield
        finally:
            self._depth -= 1

    def decode_layer(self, cache: Any, i: int) -> Any:
        """Layer ``i``'s tree of a stacked decode cache.  A leaf whose
        layer dim is split (a decode batch laid out by
        ``batch_shardings``, which splits every leaf's leading dim, as
        the JAX dry run's does) holds layer ``i`` on one rank of the
        split: that rank sends each rank of it the layer's batch rows
        that rank takes, one all-to-all of uneven splits (the whole
        layer to each where the batch does not divide), so that a rank
        holds the leaf plus one layer's rows, as XLA's scan over the
        layers moves one layer at a time.  The moved slice is laid out
        by batch over those mesh dims and as the leaf on the others;
        ``write_kv_`` and ``write_state_`` write into the leaf, in place,
        what the step writes into it.  Any other leaf gives its view
        ``x[i]``."""
        return map_leaves(lambda x: self._fetch_layer(x, i)
                          if self._layer_dims(x) else x[i], cache)

    def _layer_dims(self, x: torch.Tensor) -> Tuple[int, ...]:
        """The mesh dims (of more than one rank) that split a DTensor's
        leading dim."""
        if not isinstance(x, DTensor):
            return ()
        return tuple(d for d, p in enumerate(x.placements)
                     if p.is_shard(0) and self.mesh.size(d) > 1)

    def _fetch_layer(self, x: DTensor, i: int) -> DTensor:
        dims = self._layer_dims(x)
        n = math.prod(self.mesh.size(d) for d in dims)
        coord = self.mesh.get_coordinate()
        me = 0
        for d in dims:
            me = me * self.mesh.size(d) + coord[d]
        local = x.to_local()
        owner, li = divmod(i, local.shape[0])
        b = local.shape[1]
        split = b % n == 0 and not any(p.is_shard(1) for p in x.placements)
        rows = b // n if split else b
        if me == owner:
            src = local[li]
            if not split:
                src = src.expand((n,) + tuple(src.shape)).flatten(0, 1)
            sends = [rows] * n
        else:
            src = local.new_empty((0,) + tuple(local.shape[2:]))
            sends = [0] * n
        got = funcol.wait_tensor(funcol.all_to_all_single(
            src.contiguous(), [rows if j == owner else 0 for j in range(n)],
            sends, self._group(dims)))
        placements = tuple(
            (Shard(0) if split else Replicate()) if d in dims
            else Shard(p.dim - 1) if p.is_shard() else p
            for d, p in enumerate(x.placements))
        shape = tuple(x.shape[1:])
        moved = DTensor.from_local(got, self.mesh, placements,
                                   run_check=False, shape=shape,
                                   stride=contiguous_strides(shape))
        self._homes[moved] = _Home(local[li] if me == owner else None,
                                   dims, split, owner, n)
        return moved

    def _group(self, dims: Tuple[int, ...]):
        """The process group of the ranks along ``dims`` (one mesh dim's,
        or the flattened dims', in DTensor's order of their shards)."""
        if len(dims) == 1:
            return self.mesh.get_group(dims[0])
        if dims not in self._groups:
            names = tuple(self.mesh.mesh_dim_names[d] for d in dims)
            self._groups[dims] = self.mesh[names]._flatten().get_group(0)
        return self._groups[dims]

    def _write_home(self, moved: DTensor, new: torch.Tensor,
                    write) -> None:
        """After a write into a slice ``decode_layer`` moved: ``new``, the
        rank's local rows of what was written (laid out as ``moved``),
        sent to the rank that holds the layer (one all-to-all, the
        fetch's reverse; nothing to send where each rank holds the
        whole layer), which runs ``write(layer, rows)`` into its local
        slice of the leaf."""
        home = self._homes[moved]
        if home.split:
            r = new.shape[0]
            mine = home.layer is not None
            new = funcol.wait_tensor(funcol.all_to_all_single(
                new.contiguous(), [r if mine else 0] * home.n,
                [r if j == home.owner else 0 for j in range(home.n)],
                self._group(home.dims)))
        if home.layer is not None:
            write(home.layer, new)

    def write_kv_(self, ck: torch.Tensor, cv: torch.Tensor,
                  slot: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> None:
        """The in-place cache write on each rank's local shards: the
        index and the new rows are laid out like the cache's rows and
        heads first, so each rank writes its own rows and heads (DTensor's
        own in-place writes into a sharded tensor are refused in torch
        2.11).

        A cache split along its slots (dim 2, the "kv_seq" rule) holds
        slots ``[offset, offset + n)`` on each rank: a row's write lands
        on the rank whose range holds its slot, at ``slot - offset``, and
        every other rank writes that row's old value back in place (the
        index clamped into its range), so no collective and no branch on
        a tensor value is needed (fake tensors have no values)."""
        if not isinstance(ck, DTensor):
            return super().write_kv_(ck, cv, slot, k, v)
        reps = [Replicate()] * self.mesh.ndim
        for t, new in ((ck, k), (cv, v)):
            want = tuple(t.placements)
            # the new rows keep dim 2 whole: it has one slot
            rows = tuple(Replicate() if p.is_shard(2) else p for p in want)
            new = new.unsqueeze(2)                     # (b, kvh, 1, hd)
            idx = slot[:, None, None, None].expand(new.shape)

            def like_t(x):
                if not isinstance(x, DTensor):
                    x = DTensor.from_local(x, self.mesh, reps,
                                           run_check=False)
                return x.redistribute(self.mesh, rows).to_local()
            local, idx, new = t.to_local(), like_t(idx), like_t(new)
            if rows != want:
                _, offset = local_shape_and_offset(tuple(t.shape),
                                                   self.mesh, want)
                n = local.shape[2]
                pos = idx - offset[2]
                inside = (pos >= 0) & (pos < n)
                idx = pos.clamp(0, n - 1)
                new = torch.where(inside, new, local.gather(2, idx))
            local.scatter_(2, idx, new)
            if t in self._homes:
                # the layer's slots in the leaf: every row's, at its slot
                whole = (slot.full_tensor() if isinstance(slot, DTensor)
                         else slot)

                def write(layer, rows, whole=whole):
                    layer.scatter_(2, whole[:, None, None, None].expand(
                        rows.shape), rows)
                self._write_home(t, new, write)

    def write_state_(self, state: torch.Tensor, new: torch.Tensor
                     ) -> None:
        """The new state written into ``state`` in place; into the
        stacked leaf where ``decode_layer`` moved ``state`` out of it
        (the moved slice itself, which the step drops, is not
        written)."""
        if not isinstance(state, DTensor) or state not in self._homes:
            return super().write_state_(state, new)
        if not isinstance(new, DTensor):
            new = DTensor.from_local(new, self.mesh,
                                     [Replicate()] * self.mesh.ndim,
                                     run_check=False)
        rows = new.redistribute(self.mesh, state.placements).to_local()
        self._write_home(state, rows, lambda layer, r: layer.copy_(r))

    # -- shardings ---------------------------------------------------------
    def sharding(self, axes: Tuple[Optional[str], ...]) -> NamedSharding:
        return NamedSharding(self.mesh, self.rules.placements(
            self.rules.spec(tuple(axes)), self.mesh))

    def param_shardings(self, axes_tree: Any) -> Any:
        """A ``NamedSharding`` tree from a tree of ``Axes`` leaves
        (``Model.param_specs()[1]``, ``train_state_specs``' axes)."""
        return map_leaves(self.sharding, axes_tree)

    def batch_shardings(self, batch: Any) -> Any:
        """Data-parallel shardings of a batch tree (tensors or
        ``TensorSpec``s): the leading dim of every leaf is the global
        batch, split over the DP axes when they divide it; everything
        else is replicated."""
        dp_axes = self.rules.mapping.get("batch")
        dp = self.rules.size("batch")

        def one(s):
            shape = tuple(s.shape)
            if dp_axes and len(shape) >= 1 and shape[0] > 0 \
                    and shape[0] % dp == 0:
                entry = dp_axes[0] if len(dp_axes) == 1 else tuple(dp_axes)
                spec = PartitionSpec(entry, *([None] * (len(shape) - 1)))
            else:
                spec = PartitionSpec()
            return NamedSharding(self.mesh,
                                 self.rules.placements(spec, self.mesh))

        return map_leaves(one, batch)

    def distribute(self, tree: Any, shardings: Any) -> Any:
        """Put a tree of tensors on the mesh, each leaf by its
        ``NamedSharding`` (``distribute_tensor``, rank 0's values; a leaf
        that requires grad stays a leaf that requires grad)."""
        return map_leaves(lambda x, s: distribute_tensor(
            x, s.mesh, s.placements), tree, shardings)

    # -- internals -------------------------------------------------------
    def _spec_for_shape(self, shape: Tuple[int, ...],
                        axes: Tuple[Optional[str], ...]) -> PartitionSpec:
        """Like ``rules.spec`` but drops mesh axes whose size does not
        divide the concrete dimension: an uneven activation dim stays
        replicated, as in JAX, where DTensor would shard it unevenly."""
        used: set = set()
        entries = []
        for dim, name in zip(shape, axes):
            mesh_axes_ = self.rules.mapping.get(name) if name else None
            if mesh_axes_:
                mesh_axes_ = tuple(a for a in mesh_axes_ if a not in used)
                nshards = math.prod(self.rules.axis_sizes.get(a, 1)
                                    for a in mesh_axes_)
                if nshards and dim % nshards != 0:
                    mesh_axes_ = ()
            if not mesh_axes_:
                entries.append(None)
                continue
            used.update(mesh_axes_)
            entries.append(mesh_axes_[0] if len(mesh_axes_) == 1
                           else tuple(mesh_axes_))
        return PartitionSpec(*entries)
