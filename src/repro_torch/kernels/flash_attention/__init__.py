"""Causal (optionally sliding-window) flash attention for Hopper."""
