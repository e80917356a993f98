"""Weights and decode state carried across from the JAX package.

``params_from_jax`` takes the reference's parameter pytree as numpy
arrays (``jax.tree.map(np.asarray, params)``, done by the caller: the
port imports no JAX) and returns the port's :class:`Params` with the same
names and shapes, matrices in ``cfg.dtype`` and norm weights in float32.
``cache_from_jax`` and ``cache_to_numpy`` do the same for the decode
cache, a tuple over period positions of ``(k, v)``; numpy has no
bfloat16, so bf16 caches travel as float32 values (exact: every bf16 is
a float32).
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params
from repro_torch.models.transformer import to_params


def _tensor(x, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.kind not in "fiub" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr, order="C"))   # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: Mapping, cfg: ModelConfig, device="cpu"
                    ) -> Params:
    """The port's parameters from the reference's numpy pytree."""
    def conv(x):
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return tuple(conv(v) for v in x)
        return _tensor(x, None, "cpu")
    return to_params(conv(tree), cfg, device)


def cache_from_jax(cache: Any, dtype: torch.dtype = torch.bfloat16,
                   device="cpu") -> Tuple[Tuple[torch.Tensor, ...], ...]:
    """The port's decode cache from the reference's (numpy) cache."""
    return tuple(tuple(_tensor(x, dtype, device) for x in kv)
                 for kv in cache)


def cache_to_numpy(cache: Any) -> Tuple[Tuple[np.ndarray, ...], ...]:
    """A decode cache as float32 numpy arrays (either package's)."""
    def arr(x):
        if isinstance(x, torch.Tensor):
            return x.detach().float().cpu().numpy()
        return np.asarray(x, dtype=np.float32)
    return tuple(tuple(arr(x) for x in kv) for kv in cache)
