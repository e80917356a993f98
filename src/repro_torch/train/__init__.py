"""Serving loop of the port (``repro/train``; the trainer is not ported
yet, ROADMAP Queue 1 item 11)."""
from repro_torch.train.serve import Server, ServeConfig, ServeStats

__all__ = ["Server", "ServeConfig", "ServeStats"]
