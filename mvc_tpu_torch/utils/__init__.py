"""Device selection, the JAX weights bridge and the reference checkpoint
converter."""
from mvc_tpu_torch.utils.checkpoint_convert import convert_reference_checkpoint

__all__ = ["convert_reference_checkpoint"]
