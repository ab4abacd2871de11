from .train_step import (TrainConfig, TrainState, init_train_state,
                         load_train_state_, make_train_step)

__all__ = ["TrainConfig", "TrainState", "init_train_state",
           "load_train_state_", "make_train_step"]
