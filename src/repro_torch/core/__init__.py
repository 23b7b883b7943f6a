"""The fidelity layer of the port (``repro.core.fidelity``'s twin): run a
step natively, cost it on fake tensors, or hand its cost to a replay on a
machine model."""
