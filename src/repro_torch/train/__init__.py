"""Training: the step factory, the fault-tolerant trainer loop and the
straggler monitor."""
from repro_torch.train.step import (TrainState, init_train_state,
                                    make_train_step, train_state_from_numpy)
from repro_torch.train.trainer import StragglerMonitor, Trainer, TrainerConfig

__all__ = ["TrainState", "make_train_step", "init_train_state",
           "train_state_from_numpy", "Trainer", "TrainerConfig",
           "StragglerMonitor"]
