"""repro_torch.checkpoint — atomic step-tagged snapshots of tensor trees."""
from .ckpt import latest_step, restore, save

__all__ = ["save", "restore", "latest_step"]
