"""repro_torch.sim — the gem5-stdlib-style simulation front-end, copied
from ``repro.sim``: the port imports nothing of the JAX package.

One import gives the workflow the gem5 paper's pillars describe
(§1.3 checkpoint/restore, fast-forward; PAPERS.md "Toward Reproducible
and Standardized Computer Architecture Simulation"):

* :class:`Simulator` + :class:`ExitEvent` — instantiate/run/exit loop.
* :mod:`repro_torch.sim.boards` — prebuilt machines (``h100_card()``,
  and the reference's ``v5e_*`` boards).
* :mod:`repro_torch.sim.serialize` — drain-then-serialize checkpoints.
* :mod:`repro_torch.sim.instrument` — m5out-style output dirs,
  gem5-format stats dumps, Perfetto trace export, host telemetry (with
  the debug flag/DPRINTF layer in :mod:`repro_torch.core.trace`).

No entry point of the port reaches the reference's sampled simulation,
fingerprints, checkpoint library or fleet (``repro.sim.sampling``,
``fingerprint``, ``ckptlib``, ``fleet``): they are not copied.
"""

from repro_torch.core.trace import (disable as disable_debug_flags,
                                    enable as enable_debug_flags,
                                    flag_context, flags as debug_flags)
from repro_torch.sim.boards import (BOARDS, Board, get_board, h100_card,
                                    v5e_degraded, v5e_fleet, v5e_fleet_big,
                                    v5e_multipod, v5e_pod, v5e_serving,
                                    v5e_straggler, v5e_unreliable)
from repro_torch.sim.instrument import (OutDir, TraceEventRecorder,
                                        format_host_banner, host_record,
                                        render_stats_txt,
                                        validate_trace_events)
from repro_torch.sim.parallel import (ParallelEngine, merge_stat_trees,
                                      parallel_supported, run_parallel)
from repro_torch.sim.serialize import (CHECKPOINT_VERSION, WORKLOAD_KEY,
                                       WORKLOAD_KIND_KEY, CheckpointError,
                                       checkpoint_executor, load_checkpoint,
                                       machine_from_dict, restore_executor,
                                       save_checkpoint)
from repro_torch.sim.simulator import (ExitEvent, ExitEventType, Simulator,
                                       SteadyStateWorkload, repeat_trace)
from repro_torch.sim.workloads import (DynamicWorkload, ServeRequest,
                                       ServeSim, ServingCost, TrainSim,
                                       TrainStepCost, poisson_requests,
                                       trace_requests, uniform_requests)

__all__ = [
    "Board", "BOARDS", "get_board", "h100_card", "v5e_pod", "v5e_multipod",
    "v5e_straggler", "v5e_degraded", "v5e_serving", "v5e_fleet",
    "v5e_fleet_big", "v5e_unreliable",
    "Simulator", "ExitEvent", "ExitEventType", "SteadyStateWorkload",
    "repeat_trace",
    "DynamicWorkload", "ServeSim", "ServeRequest", "ServingCost",
    "TrainSim", "TrainStepCost",
    "poisson_requests", "trace_requests", "uniform_requests",
    "CHECKPOINT_VERSION", "WORKLOAD_KEY", "WORKLOAD_KIND_KEY",
    "CheckpointError",
    "checkpoint_executor", "save_checkpoint", "load_checkpoint",
    "restore_executor", "machine_from_dict",
    "ParallelEngine", "run_parallel", "parallel_supported",
    "merge_stat_trees",
    "OutDir", "TraceEventRecorder", "render_stats_txt", "host_record",
    "format_host_banner", "validate_trace_events",
    "enable_debug_flags", "disable_debug_flags", "debug_flags",
    "flag_context",
]
