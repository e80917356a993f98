"""Weights and decode state carried across from the JAX package.

``params_from_jax`` takes the reference's parameter pytree as numpy
arrays (``jax.tree.map(np.asarray, params)``, done by the caller: the
port imports no JAX) and returns the port's :class:`Params` with the same
names and shapes, matrices in ``cfg.dtype``, norm weights (the
enc-dec LayerNorms' ``w`` and ``b``) and the SSD's float32 parameters in
float32 (``transformer.FLOAT32``); with ``master=True``, the trainer's
tree: every leaf float32, as the reference keeps it, taking a gradient.
The enc-dec tree (``enc`` and ``dec`` stacked by the reference's
``vmap``, ``pos_dec``, ``ln_enc``, ``ln_dec``) converts by the same
names.  ``cache_from_jax`` and ``cache_to_numpy`` do the same for the
decode cache: a tuple over period positions of ``(k, v)`` or ``(ssm_h,
conv_state)``, or the enc-dec ``(self_kv, cross_kv)``.  Each leaf keeps
its role's dtype: ``ssm_h`` is float32 whatever the cache dtype, as the
reference keeps it (``ssm.py:198-203``), and the rest take the cache
dtype.  numpy has no bfloat16, so bf16 caches travel as float32 values
(exact: every bf16 is a float32).
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


def params_from_jax(tree: Mapping, cfg: ModelConfig, device="cpu",
                    master: bool = False) -> Params:
    """The port's parameters from the reference's numpy pytree (the
    trainer's float32 masters with ``master``)."""
    def conv(x):
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return tuple(conv(v) for v in x)
        return _tensor(x, None, "cpu")
    return to_params(conv(tree), cfg, device, master=master)


def leaf_dtypes(pair: Tuple, dtype: torch.dtype) -> Tuple[torch.dtype, ...]:
    """The dtypes of one period position's cache leaves: an SSD position,
    ``(ssm_h (G, B, H, S, P), conv_state (G, B, K-1, C))``, keeps ``ssm_h``
    in float32; attention's ``(k, v)`` and ``conv_state`` take ``dtype``."""
    if len(pair) == 2 and np.ndim(pair[1]) == 4:
        return torch.float32, dtype
    return (dtype,) * len(pair)


def cache_from_jax(cache: Any, dtype: torch.dtype = torch.bfloat16,
                   device="cpu") -> Tuple[Tuple[torch.Tensor, ...], ...]:
    """The port's decode cache from the reference's (numpy) cache, each
    leaf in its role's dtype (:func:`leaf_dtypes`)."""
    return tuple(tuple(_tensor(x, dt, device)
                       for x, dt in zip(pair, leaf_dtypes(pair, dtype)))
                 for pair in cache)


def cache_to_numpy(cache: Any) -> Tuple[Tuple[np.ndarray, ...], ...]:
    """A decode cache as float32 numpy arrays (either package's): exact
    for every leaf, float32 ``ssm_h`` and bf16 ``conv_state`` alike."""
    def arr(x):
        if isinstance(x, torch.Tensor):
            return x.detach().float().cpu().numpy()
        return np.asarray(x, dtype=np.float32)
    return tuple(tuple(arr(x) for x in kv) for kv in cache)
