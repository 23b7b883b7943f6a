"""The fidelity layer of the port (``repro.core.fidelity``'s twin): run a
step natively, cost it on fake tensors, or replay its cost on the port's
own discrete-event simulator (``core.desim``, a copy of the reference's,
its machine set to the card)."""
