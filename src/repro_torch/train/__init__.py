from .step import make_loss_fn, make_train_step
from .trainer import Trainer

__all__ = ["make_loss_fn", "make_train_step", "Trainer"]
