from repro_torch.train.trainer import (TrainOptions, TrainState, Trainer,
                                       make_train_step)

__all__ = ["TrainOptions", "TrainState", "Trainer", "make_train_step"]
