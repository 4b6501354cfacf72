from .step import TrainState, init_train_state, make_train_step
from .trainer import Trainer, TrainerConfig

__all__ = ["TrainState", "Trainer", "TrainerConfig", "init_train_state",
           "make_train_step"]
