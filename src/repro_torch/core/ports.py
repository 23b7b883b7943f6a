"""A copy of ``repro.core.ports`` (pure Python): the port imports nothing
of the JAX package.  Its source below this docstring equals the
original's, imports renamed, and a test holds the two in step.

Modular port interface (gem5-20 paper §1.3.1 ③).

gem5's port system lets "any component that implements the port API be
connected to any other component implementing the same API".  Ports are
what make gem5 configurations *composable*: the Python script wires a
CPU's memory port to a cache's CPU-side port with ``a.port = b.port``.

g5x uses ports to wire framework components: the data pipeline's output
port to the trainer's input port, the trainer's checkpoint port to the
checkpoint manager, desim machine components to network links, etc.
Ports are typed by a *protocol* string; only matching protocols connect
(the analogue of gem5's requestor/responder packet protocol check).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional


class PortError(RuntimeError):
    pass


class Port:
    """One endpoint.  ``role`` is 'requestor' or 'responder'."""

    def __init__(self, owner: Any, name: str, protocol: str, role: str):
        if role not in ("requestor", "responder"):
            raise PortError(f"bad role {role!r}")
        self.owner = owner
        self.name = name
        self.protocol = protocol
        self.role = role
        self.peer: Optional[Port] = None
        self._handler: Optional[Callable[[Any], Any]] = None

    # -- wiring ------------------------------------------------------------
    def connect(self, other: "Port") -> None:
        if self.protocol != other.protocol:
            raise PortError(
                f"protocol mismatch: {self.protocol!r} vs {other.protocol!r}")
        if self.role == other.role:
            raise PortError(f"cannot connect two {self.role} ports")
        if self.peer is not None or other.peer is not None:
            raise PortError("port already connected")
        self.peer = other
        other.peer = self

    def __mod__(self, other: "Port") -> "Port":  # a.port % b.port sugar
        self.connect(other)
        return self

    def connected(self) -> bool:
        return self.peer is not None

    # -- transport -----------------------------------------------------------
    def set_handler(self, fn: Callable[[Any], Any]) -> None:
        """Responder side: install the request handler."""
        if self.role != "responder":
            raise PortError("handlers live on responder ports")
        self._handler = fn

    def send(self, payload: Any) -> Any:
        """Requestor side: deliver ``payload`` to the peer's handler.

        This is gem5's *atomic* protocol (call-through, returns the
        response immediately).  The desim layer adds the *timing*
        protocol on top by scheduling events.
        """
        if self.role != "requestor":
            raise PortError("send() from a responder port")
        if self.peer is None:
            raise PortError(f"port {self.name} is not connected")
        if self.peer._handler is None:
            raise PortError(f"peer port {self.peer.name} has no handler")
        return self.peer._handler(payload)


class PortSet:
    """Helper mixing ports into a SimObject."""

    def __init__(self, owner: Any):
        self.owner = owner
        self._ports: List[Port] = []

    def requestor(self, name: str, protocol: str) -> Port:
        p = Port(self.owner, name, protocol, "requestor")
        self._ports.append(p)
        return p

    def responder(self, name: str, protocol: str,
                  handler: Optional[Callable[[Any], Any]] = None) -> Port:
        p = Port(self.owner, name, protocol, "responder")
        if handler is not None:
            p.set_handler(handler)
        self._ports.append(p)
        return p

    def all_connected(self) -> bool:
        return all(p.connected() for p in self._ports)

    def unconnected(self) -> List[str]:
        return [p.name for p in self._ports if not p.connected()]
