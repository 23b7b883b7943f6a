"""Training of the port: the train step (``train.step``).  The
``Trainer`` loop with checkpointing and fault tolerance comes with
ROADMAP.md Queue 1 items 7-8."""

from repro_torch.train.step import (  # noqa: F401
    TrainOptions, batch_to, build_train_step, default_options_for,
    init_train_state, lr_at)
