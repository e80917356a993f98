"""Training and serving loops of the port (``repro/train``)."""
from repro_torch.train.loop import Trainer, TrainConfig, make_train_step
from repro_torch.train.serve import Server, ServeConfig, ServeStats

__all__ = ["Trainer", "TrainConfig", "make_train_step", "Server",
           "ServeConfig", "ServeStats"]
