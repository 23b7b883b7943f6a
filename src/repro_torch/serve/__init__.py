"""Serving of the port: the continuous-batching server, its steps, its
(copied) pure slot-scheduler policy and the fleet's (copied) pure router
and autoscaler with their controller."""

from repro_torch.serve.fleet import FleetController  # noqa: F401
from repro_torch.serve.fleet_policy import (FleetDecision,  # noqa: F401
                                            FleetPolicy)
from repro_torch.serve.policy import Decision, SlotScheduler  # noqa: F401
from repro_torch.serve.server import BatchServer, Request  # noqa: F401
from repro_torch.serve.step import (build_decode_step,  # noqa: F401
                                    build_prefill_step)
