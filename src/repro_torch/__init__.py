"""PyTorch/CUDA port of the JAX model and serving stack (``repro``).

The port imports ``torch`` and never ``jax``, and nothing of the
``repro`` package: it keeps its own copies of the plain modules it needs
(configs, the slot-scheduler policy).  Every entry point runs on the GPU
unless the caller passes ``device="cpu"``.

Covered so far: the dense and MoE decoder families (``models``), served
through ``serve.BatchServer``, with prefill attention and the MoE expert
FFN in hand-written Hopper kernels (``kernels.flash_attention``,
``kernels.moe_mlp``).
"""

from repro_torch.device import resolve_device  # noqa: F401
