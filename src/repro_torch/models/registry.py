"""Architecture registry: config lookup and the model API.

The counterpart of ``repro/models/registry.py``: ``canon``,
``get_config``, ``Model`` (``init``, ``forward``, ``init_cache``) and
``build``.  ``ARCHS`` lists all ten architectures of the reference, and
the port runs all ten: the four dense ones (gemma2-9b, qwen1.5-4b,
deepseek-7b, qwen2.5-32b), the MoE granite-moe-1b-a400m and
moonshot-v1-16b-a3b, the SSM mamba2-1.3b, the hybrid
jamba-1.5-large-398b, the enc-dec whisper-tiny (``models/encdec.py``) and
the VLM pixtral-12b.  ``Model`` dispatches on the family as
``repro/models/registry.py:55-85`` does.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer

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


# public ids use dashes/dots; module names use underscores
def canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(
        f"repro_torch.configs.{canon(arch)}").CONFIG


@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    @classmethod
    def from_config(cls, cfg: ModelConfig) -> "Model":
        return cls(cfg)

    def _family(self):
        return encdec if self.cfg.family == "encdec" else transformer

    def init(self, gen: torch.Generator, device,
             master: bool = False) -> transformer.Params:
        """Seeded random weights on ``device`` (``gen`` lives there too).
        With ``master``, the trainer's tree: every leaf float32 (the
        reference's own storage) and taking a gradient; each use casts to
        ``cfg.dtype``.  Without it, the serving storage of
        ``models/layers.py``."""
        cfg = dataclasses.replace(self.cfg, dtype="float32") if master \
            else self.cfg
        return self._family().init_model(gen, cfg, device).requires_grad_(
            master)

    def forward(self, params, tokens, **kw):
        """Returns (logits, aux_loss, new_cache); the keywords go to the
        family's ``forward`` (``moe_impl`` only to ``transformer``'s: the
        enc-dec family has no MoE)."""
        if self.cfg.family == "encdec":
            kw.pop("moe_impl", None)
        return self._family().forward(params, self.cfg, tokens, **kw)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16, device=None):
        return self._family().init_cache(self.cfg, batch, max_len, dtype,
                                         device)

    def extra_inputs(self, batch: int, seq: int) -> Dict[str, tuple]:
        """Shapes of the stub-frontend inputs this family requires."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return {"frames": (batch, cfg.encoder_seq, cfg.d_model)}
        if cfg.family == "vlm" and cfg.patch_prefix:
            return {"patch_embeds": (batch, cfg.patch_prefix, cfg.d_model)}
        return {}

    def text_len(self, seq: int) -> int:
        """Token positions in a total sequence budget (a VLM reserves
        its patch prefix inside the budget)."""
        if self.cfg.family == "vlm" and self.cfg.patch_prefix:
            return seq - self.cfg.patch_prefix
        return seq


def build(arch: str) -> Tuple[Model, ModelConfig]:
    cfg = get_config(arch)
    return Model.from_config(cfg), cfg
