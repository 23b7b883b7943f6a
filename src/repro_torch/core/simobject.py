"""A copy of ``repro.core.simobject`` (pure Python): the port imports nothing of
the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

SimObject: parameterized, hierarchical, Python-composed components.

gem5's key usability contribution (§1.3) is that systems are *composed
dynamically in Python*: every model is a ``SimObject`` with declared,
type-checked ``Param``s; users instantiate and wire objects in a script,
then call ``instantiate()``.  g5x reproduces that model and uses it for
*everything*: meshes, machine models, architectures, optimizers, data
pipelines, trainers and servers are all SimObjects.

Key mechanics mirrored from gem5:

* ``Param`` descriptors with defaults, type coercion and validation
  (gem5's ``Param.Int``, ``Param.MemorySize``, ...).
* parent/child hierarchy with dotted paths (``system.trainer.optimizer``)
  — children are discovered by attribute assignment, exactly like gem5.
* a per-object ``StatGroup`` bound into the tree (paper §2.21.1: "there
  is a tree of statistics groups that match the SimObject graph").
* ``instantiate()`` walks the tree, validates params, calls ``startup()``
  bottom-up, and freezes the hierarchy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Type

from repro_torch.core.stats import StatGroup


class ParamError(TypeError):
    pass


class Param:
    """Typed, validated parameter descriptor (gem5 ``Param.*`` analogue).

    >>> class Cache(SimObject):
    ...     size_kb = Param(int, 32, "cache size in KiB", check=lambda v: v > 0)
    >>> c = Cache(size_kb=64)
    >>> c.size_kb
    64
    """

    def __init__(self, ptype: type, default: Any = None, desc: str = "",
                 check: Optional[Callable[[Any], bool]] = None,
                 choices: Optional[tuple] = None):
        self.ptype = ptype
        self.default = default
        self.desc = desc
        self.check = check
        self.choices = choices
        self.name: str = "?"

    def __set_name__(self, owner, name):
        self.name = name

    def coerce(self, value: Any) -> Any:
        if value is None:
            return None
        if self.ptype is float and isinstance(value, int):
            value = float(value)
        if not isinstance(value, self.ptype):
            try:
                value = self.ptype(value)
            except Exception as e:  # pragma: no cover - error path
                raise ParamError(
                    f"param {self.name}: cannot coerce {value!r} to "
                    f"{self.ptype.__name__}") from e
        if self.choices is not None and value not in self.choices:
            raise ParamError(
                f"param {self.name}: {value!r} not in {self.choices}")
        if self.check is not None and not self.check(value):
            raise ParamError(f"param {self.name}: {value!r} failed validation")
        return value

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj._params.get(self.name, self.default)

    def __set__(self, obj, value):
        if getattr(obj, "_frozen", False):
            raise ParamError(
                f"cannot set param {self.name} after instantiate()")
        obj._params[self.name] = self.coerce(value)


class SimObject:
    """Base class for every parameterized g5x component."""

    def __init__(self, name: Optional[str] = None, **params):
        object.__setattr__(self, "_params", {})
        object.__setattr__(self, "_children", {})
        object.__setattr__(self, "_parent", None)
        object.__setattr__(self, "_frozen", False)
        self._name = name or type(self).__name__.lower()
        self.stats = StatGroup(self._name)
        declared = self._declared_params()
        for k, v in params.items():
            if k not in declared:
                raise ParamError(
                    f"{type(self).__name__} has no param {k!r} "
                    f"(declared: {sorted(declared)})")
            setattr(self, k, v)

    # -- params --------------------------------------------------------
    @classmethod
    def _declared_params(cls) -> Dict[str, Param]:
        out: Dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, Param):
                    out[k] = v
        return out

    def params_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._declared_params()}

    # -- hierarchy ------------------------------------------------------
    def __setattr__(self, key, value):
        if isinstance(value, SimObject) and not key.startswith("_"):
            if self._frozen:
                raise ParamError("cannot attach children after instantiate()")
            self._children[key] = value
            object.__setattr__(value, "_parent", self)
            value._name = key
            value.stats.name = key
        object.__setattr__(self, key, value)

    @property
    def name(self) -> str:
        return self._name

    @property
    def path(self) -> str:
        if self._parent is None:
            return self._name
        return f"{self._parent.path}.{self._name}"

    def children(self) -> Dict[str, "SimObject"]:
        return dict(self._children)

    def descendants(self) -> Iterator["SimObject"]:
        for child in self._children.values():
            yield child
            yield from child.descendants()

    def find(self, path: str) -> "SimObject":
        obj: SimObject = self
        for part in path.split("."):
            try:
                obj = obj._children[part]
            except KeyError:
                raise KeyError(
                    f"no child {part!r} under {obj.path!r} (resolving "
                    f"{path!r}; children: {sorted(obj._children)})"
                    ) from None
        return obj

    # -- lifecycle -------------------------------------------------------
    def startup(self) -> None:
        """Called bottom-up at instantiate() time; override for setup."""

    def instantiate(self) -> "SimObject":
        """Validate + freeze the whole tree rooted here (gem5
        ``m5.instantiate()``)."""
        for child in self._children.values():
            child.instantiate()
            self.stats.add_child(child.stats)
        # re-coerce all params (validates defaults overridden post-init)
        for pname, p in self._declared_params().items():
            self._params[pname] = p.coerce(getattr(self, pname))
        self.startup()
        object.__setattr__(self, "_frozen", True)
        return self

    # -- checkpointing (repro.sim.serialize) -------------------------------
    def serialize(self) -> Dict[str, Any]:
        """Params + children as a plain JSON-able tree (gem5's
        ``config.ini`` analogue, used by ``repro.sim.serialize`` so a
        checkpoint records the machine it was taken on)."""
        return {
            "class": type(self).__name__,
            "name": self._name,
            "params": dict(self.params_dict()),
            "children": {k: c.serialize() for k, c in self._children.items()},
        }

    def load_serialized(self, d: Dict[str, Any], strict: bool = True) -> None:
        """Apply a :meth:`serialize` dict onto this (unfrozen) tree.

        The tree must already have the same shape — this restores
        *parameters*, it does not construct objects (class registries
        are the caller's business; see ``repro.sim.serialize.
        machine_from_dict`` for the machine-model instance)."""
        declared = self._declared_params()
        for k, v in d.get("params", {}).items():
            if k in declared:
                setattr(self, k, v)
            elif strict:
                raise ParamError(
                    f"{type(self).__name__} has no param {k!r}")
        for k, cd in d.get("children", {}).items():
            child = self._children.get(k)
            if child is not None:
                child.load_serialized(cd, strict=strict)
            elif strict:
                raise KeyError(f"no child {k!r} under {self.path!r}")

    # -- introspection -----------------------------------------------------
    def describe(self, indent: int = 0) -> str:
        pad = "  " * indent
        lines = [f"{pad}{self._name}: {type(self).__name__}"]
        for k, v in sorted(self.params_dict().items()):
            lines.append(f"{pad}  .{k} = {v!r}")
        for child in self._children.values():
            lines.append(child.describe(indent + 1))
        return "\n".join(lines)

    def __repr__(self):
        return f"<{type(self).__name__} {self.path}>"


def simobject_from_dataclass(dc: Any, name: str = "cfg") -> SimObject:
    """Wrap a plain dataclass as a SimObject (for arch configs)."""
    cls_attrs: Dict[str, Any] = {}
    for f in dataclasses.fields(dc):
        cls_attrs[f.name] = Param(object if f.type is Any else type(getattr(dc, f.name)),
                                  getattr(dc, f.name), f.name)
    klass: Type[SimObject] = type(f"{type(dc).__name__}SimObject",
                                  (SimObject,), cls_attrs)
    return klass(name=name)
