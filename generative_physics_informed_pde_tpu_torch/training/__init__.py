"""SVI training loop, learning-rate schedules, the metrics record and
checkpointing."""

from .checkpoint import (restore_encoder_decoder, restore_train_state,
                         save_encoder_decoder, save_train_state)
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
    "TrainerParameters", "TrainingDivergedError", "save_train_state",
    "restore_train_state", "save_encoder_decoder", "restore_encoder_decoder",
]
