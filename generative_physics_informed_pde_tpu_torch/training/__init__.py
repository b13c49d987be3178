"""SVI training loop, learning-rate schedules and the metrics record."""

from .metrics import MetricsWriter
from .schedules import constant_lr, make_schedule, multistep_lr, step_lr
from .trainer import (DEFAULT_CONFIG, CreateDataSetsFromPermutation,
                      CreateTrainer, CreateTrainerFromPermutation, Trainer,
                      TrainerParameters, TrainingDivergedError)

__all__ = [
    "MetricsWriter", "constant_lr", "make_schedule", "multistep_lr",
    "step_lr", "DEFAULT_CONFIG", "CreateDataSetsFromPermutation",
    "CreateTrainer", "CreateTrainerFromPermutation", "Trainer",
    "TrainerParameters", "TrainingDivergedError",
]
