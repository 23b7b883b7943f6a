"""repro_torch.sim — the gem5-stdlib-style simulation front-end, copied
from ``repro.sim``: the port imports nothing of the JAX package.

One import gives the workflow the gem5 paper's pillars describe
(§1.3 checkpoint/restore, fast-forward, sampled detail; PAPERS.md
"Toward Reproducible and Standardized Computer Architecture
Simulation"):

* :class:`Simulator` + :class:`ExitEvent` — instantiate/run/exit loop.
* :mod:`repro_torch.sim.boards` — prebuilt machines (``h100_card()``,
  ``h100_fleet()``, and the reference's ``v5e_*`` boards).
* :mod:`repro_torch.sim.serialize` — drain-then-serialize checkpoints.
* :mod:`repro_torch.sim.sampling` — SimPoint/SMARTS sampled simulation;
  :mod:`repro_torch.sim.fingerprint` phase fingerprints and SimPoint
  plans; :mod:`repro_torch.sim.ckptlib` the region checkpoint library.
* :mod:`repro_torch.sim.fleet` — an autoscaled serving fleet behind the
  router and autoscaler of :mod:`repro_torch.serve.fleet_policy`.
* :mod:`repro_torch.sim.instrument` — m5out-style output dirs,
  gem5-format stats dumps, Perfetto trace export, host telemetry (with
  the debug flag/DPRINTF layer in :mod:`repro_torch.core.trace`).
"""

from repro_torch.core.trace import (disable as disable_debug_flags,
                                    enable as enable_debug_flags,
                                    flag_context, flags as debug_flags)
from repro_torch.sim.boards import (BOARDS, Board, get_board, h100_card,
                                    h100_fleet, v5e_degraded, v5e_fleet,
                                    v5e_fleet_big, v5e_multipod, v5e_pod,
                                    v5e_serving, v5e_straggler,
                                    v5e_unreliable)
from repro_torch.sim.ckptlib import (CheckpointLibrary, RegionTime,
                                     board_digest, reconstruct,
                                     restore_fanout, take_region_checkpoints,
                                     trace_digest)
from repro_torch.sim.fingerprint import (FEATURE_NAMES, Fingerprint,
                                         bursty_trace, chain_steps,
                                         cluster_fingerprint,
                                         fingerprint_trace, record_op_stream,
                                         simpoint_plan)
from repro_torch.sim.fleet import (FleetRequest, FleetSim, diurnal_requests,
                                   flash_crowd_requests)
from repro_torch.sim.instrument import (OutDir, TraceEventRecorder,
                                        format_host_banner, host_record,
                                        render_stats_txt,
                                        validate_trace_events)
from repro_torch.sim.parallel import (ParallelEngine, merge_stat_trees,
                                      parallel_supported, run_parallel)
from repro_torch.sim.sampling import (SampledResult, SampledSimulation,
                                      SamplePlan, SimPointPlan,
                                      atomic_step_time_s, sampled_run)
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
    "Board", "BOARDS", "get_board", "h100_card", "h100_fleet", "v5e_pod",
    "v5e_multipod",
    "v5e_straggler", "v5e_degraded", "v5e_serving", "v5e_fleet",
    "v5e_fleet_big", "v5e_unreliable",
    "Simulator", "ExitEvent", "ExitEventType", "SteadyStateWorkload",
    "repeat_trace",
    "DynamicWorkload", "ServeSim", "ServeRequest", "ServingCost",
    "TrainSim", "TrainStepCost",
    "poisson_requests", "trace_requests", "uniform_requests",
    "FleetSim", "FleetRequest", "diurnal_requests",
    "flash_crowd_requests",
    "SamplePlan", "SimPointPlan", "SampledResult", "SampledSimulation",
    "sampled_run", "atomic_step_time_s",
    "FEATURE_NAMES", "Fingerprint", "fingerprint_trace",
    "cluster_fingerprint", "simpoint_plan", "record_op_stream",
    "chain_steps", "bursty_trace",
    "CheckpointLibrary", "RegionTime", "board_digest", "trace_digest",
    "take_region_checkpoints", "restore_fanout", "reconstruct",
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
