"""Training: the trainer, its losses, optimizer and checkpoints
(``mvc_tpu/training/``)."""
from mvc_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from mvc_tpu_torch.training.losses import (
    ModalityWiseReconstructionLossBuilder,
    entropy_loss,
    global_reconstruction_loss,
    local_reconstruction_loss,
    modality_wise_reconstruction_loss,
    total_reconstruction_loss,
)
from mvc_tpu_torch.training.optimizer import PlateauScheduler, make_optimizer
from mvc_tpu_torch.training.trainer import Trainer

__all__ = [
    "PlateauScheduler",
    "make_optimizer",
    "load_checkpoint",
    "save_checkpoint",
    "Trainer",
    "entropy_loss",
    "global_reconstruction_loss",
    "local_reconstruction_loss",
    "modality_wise_reconstruction_loss",
    "total_reconstruction_loss",
    "ModalityWiseReconstructionLossBuilder",
]
