"""Model substrate of the port: the dense architectures behind the
reference's model API (``repro/models``)."""
from repro_torch.models.registry import (ARCHS, Model, build, canon,
                                         get_config)

__all__ = ["ARCHS", "Model", "build", "canon", "get_config"]
