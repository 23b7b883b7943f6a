"""Fused SwiGLU expert FFN over MoE capacity blocks for Hopper."""
