"""Training of the port: the train step (``train.step``), the ``Trainer``
loop with checkpointing and fault tolerance (``train.trainer``), and the
pure fault-tolerance policy it shares with the simulator (``train.ft``,
``train.ft_policy``), with the exports of ``repro.train``."""

from repro_torch.train.ft import (  # noqa: F401 (pure)
    Heartbeat, MeshPlan, StragglerWatchdog, plan_elastic_mesh)
from repro_torch.train.ft_policy import (  # noqa: F401 (pure)
    FailureEvent, FailureSchedule, FTDecision, FTPolicy, StepPlan,
    checkpoint_due, daly_interval, young_interval)
from repro_torch.train.step import (  # noqa: F401
    TrainOptions, batch_to, build_train_step, default_options_for,
    init_train_state, lr_at, train_state_specs)
from repro_torch.train.trainer import SimulatedFailure, Trainer  # noqa: F401
