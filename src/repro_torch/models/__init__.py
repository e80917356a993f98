"""Model substrate of the port: the ten architectures (dense, MoE, SSM,
hybrid, enc-dec, VLM) behind the reference's model API
(``repro/models``)."""
from repro_torch.models.registry import (ARCHS, Model, build, canon,
                                         get_config)

__all__ = ["ARCHS", "Model", "build", "canon", "get_config"]
