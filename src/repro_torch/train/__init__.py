"""The port's training path: the train step, the loop with restarts
(:mod:`.loop`) and checkpoints (:mod:`.checkpoint`)."""

from .checkpoint import CheckpointManager  # noqa: F401
from .loop import TrainConfig, TrainLoop, make_train_step, run_with_restarts  # noqa: F401
