"""SVI training loop, learning-rate schedules and the metrics record."""

from .metrics import MetricsWriter
from .schedules import (PlateauController, constant_lr, make_schedule,
                        multistep_lr, step_lr)
from .trainer import (DEFAULT_CONFIG, CreateDataSetsFromPermutation,
                      CreateTrainer, CreateTrainerFromPermutation, Trainer,
                      TrainerParameters, TrainingDivergedError,
                      resolve_pe_compute_dtype)

__all__ = [
    "MetricsWriter", "PlateauController", "constant_lr", "make_schedule",
    "multistep_lr", "step_lr", "DEFAULT_CONFIG", "resolve_pe_compute_dtype",
    "CreateDataSetsFromPermutation",
    "CreateTrainer", "CreateTrainerFromPermutation", "Trainer",
    "TrainerParameters", "TrainingDivergedError",
]
