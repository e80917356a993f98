"""Optimizer substrate of the port (``repro/optim``): AdamW, the cosine
schedule, int8 gradient compression."""
from repro_torch.optim.adamw import AdamW, OptState
from repro_torch.optim.grad_compress import (CompressionState,
                                             compress_decompress,
                                             compressed_psum,
                                             init_compression)
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamW", "OptState", "cosine_schedule", "compress_decompress",
           "CompressionState", "init_compression", "compressed_psum"]
