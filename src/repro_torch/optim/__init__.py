"""Optimizer, schedules and gradient compression of the port, with the
exports of ``repro.optim``."""

from repro_torch.optim.adamw import (  # noqa: F401
    adamw_init, adamw_update, clip_by_global_norm, global_norm)
from repro_torch.optim.schedule import wsd_schedule, cosine_schedule  # noqa: F401
from repro_torch.optim.compress import (  # noqa: F401
    int8_block_quantize, int8_block_dequantize, compress_gradients)
