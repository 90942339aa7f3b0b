"""repro_torch.ckpt (counterpart of ``repro.ckpt``): atomic, async
checkpoints in the reference's on-disk format."""
from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
