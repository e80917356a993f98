"""Architecture registry: config lookup and the model API.

The counterpart of ``repro/models/registry.py``: ``canon``,
``get_config``, ``Model`` (``init``, ``forward``, ``init_cache``) and
``build``.  ``ARCHS`` lists all ten architectures of the reference; the
port runs eight: the four dense ones (gemma2-9b, qwen1.5-4b, deepseek-7b,
qwen2.5-32b), the MoE granite-moe-1b-a400m and moonshot-v1-16b-a3b, the
SSM mamba2-1.3b and the hybrid jamba-1.5-large-398b.  ``get_config``
raises ``NotImplementedError`` for the enc-dec whisper-tiny and the VLM
pixtral-12b (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

ARCHS = (
    "qwen1_5_4b",
    "gemma2_9b",
    "qwen2_5_32b",
    "deepseek_7b",
    "whisper_tiny",
    "granite_moe_1b_a400m",
    "moonshot_v1_16b_a3b",
    "mamba2_1_3b",
    "jamba_1_5_large_398b",
    "pixtral_12b",
)
#: the architectures whose configs the port carries
PORTED = ("qwen1_5_4b", "gemma2_9b", "qwen2_5_32b", "deepseek_7b",
          "granite_moe_1b_a400m", "moonshot_v1_16b_a3b", "mamba2_1_3b",
          "jamba_1_5_large_398b")


# public ids use dashes/dots; module names use underscores
def canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    name = canon(arch)
    if name in ARCHS and name not in PORTED:
        raise NotImplementedError(
            f"{arch}: not ported yet: the port runs {PORTED}; the enc-dec "
            f"and VLM families wait for ROADMAP Queue 1 item 11")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    @classmethod
    def from_config(cls, cfg: ModelConfig) -> "Model":
        return cls(cfg)

    def init(self, gen: torch.Generator, device) -> transformer.Params:
        """Seeded random weights on ``device`` (``gen`` lives there too)."""
        return transformer.init_model(gen, self.cfg, device)

    def forward(self, params, tokens, **kw):
        """Returns (logits, aux_loss, new_cache); ``moe_impl`` and the
        other keywords go to ``transformer.forward``."""
        return transformer.forward(params, self.cfg, tokens, **kw)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16, device=None):
        return transformer.init_cache(self.cfg, batch, max_len, dtype,
                                      device)


def build(arch: str) -> Tuple[Model, ModelConfig]:
    cfg = get_config(arch)
    return Model.from_config(cfg), cfg
