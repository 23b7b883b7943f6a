"""Discrete-event timing models of the card (gem5's detailed models),
copied from ``repro.core.desim``: the port imports nothing of the JAX
package, and its machine defaults are one NVIDIA H100 SXM5
(``machine.H100_SXM``).

This package is the g5x analogue of gem5's model library: parameterized
machine components (``machine``), a pluggable network/collective layer
(``network``, ``collectives`` — the Ruby/Garnet analogue), elastic
execution traces (``trace`` — §2.8), and the event-driven executor that
replays a trace on a machine (``executor``), including dist-gem5-style
quantum-synchronized multi-pod simulation (§2.17).  The reference's
HLO cost model (``hlo_cost``) is not copied: the port costs a step with
``core.op_cost`` instead.
"""

from repro_torch.core.desim.machine import (  # noqa: F401
    ChipModel, PodModel, ClusterModel, H100_SXM, TPU_V5E, default_cluster)
from repro_torch.core.desim.trace import HloTrace, TraceOp  # noqa: F401
from repro_torch.core.desim.simnodes import (  # noqa: F401
    ChipSim, ClusterSim, DcnSim, WireSim)
from repro_torch.core.desim.timing import (  # noqa: F401
    AtomicTiming, DetailedTiming, TimingModel, get_timing_model)
from repro_torch.core.desim.executor import (  # noqa: F401
    ExecResult, TraceExecutor, predict_step_time)
