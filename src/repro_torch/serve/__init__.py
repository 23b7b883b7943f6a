"""Serving of the port: the continuous-batching server, its steps and
its (copied) pure slot-scheduler policy."""

from repro_torch.serve.policy import Decision, SlotScheduler  # noqa: F401
from repro_torch.serve.server import BatchServer, Request  # noqa: F401
from repro_torch.serve.step import (build_decode_step,  # noqa: F401
                                    build_prefill_step)
