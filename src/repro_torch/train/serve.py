"""Serving loop with Device-First-Use placement of the decode cache.

The counterpart of ``repro/train/serve.py``, where the paper's technique
becomes a feature of the LM framework: the decode cache is a large,
massively reused buffer, exactly the object SCILIB-Accel's Device
First-Use policy was designed for.  The server allocates the cache, puts
it on the *host tier* (``memspace.HOST``), and the placement policy
decides how it reaches the device:

* ``dfu``     — migrated to device memory on its first device use (the
                prefill), then reused in place for every later token;
* ``memcopy`` — round-trips host<->device around every step (the
                conventional offload tools' behaviour; the baseline);
* ``pinned``  — born device-resident (``numactl -m 1`` analogue).

Transfer bytes, migrations and reuses are counted exactly as
``serve.py:92-155`` counts them.

A :class:`Server` runs on one device: ``device=None`` is the card
(``cuda:0``), and raises without CUDA; ``device="cpu"`` runs the
simulated tiers.  Its calls run under that device's tier mapping
(``memspace.installed``), never under the process-wide probe.  Greedy
decoding is ``torch.argmax`` (the first maximum, as ``jnp.argmax``);
temperature sampling draws from a ``torch.Generator`` seeded with
``ServeConfig.seed``, so its draws differ from JAX's by construction.
Steps run eagerly: no jit counterpart, no CUDA graphs yet.  The
reference's ``extra`` inputs (enc-dec frames, VLM patches) wait for those
families.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Tuple

import torch

from repro_torch.core import memspace
from repro_torch.core.memspace import DEVICE, HOST
from repro_torch.models.registry import Model


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 1024
    temperature: float = 0.0        # 0 = greedy
    offload_policy: str = "dfu"     # dfu | memcopy | pinned
    cache_dtype: torch.dtype = torch.bfloat16
    seed: int = 0


@dataclasses.dataclass
class ServeStats:
    bytes_host_to_dev: int = 0
    bytes_dev_to_host: int = 0
    cache_reuses: int = 0
    migrations: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens: int = 0


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for sub in tree for x in _leaves(sub)]
    return [tree]


def _tree_put(tree, tier: str) -> Tuple[Any, int]:
    """Re-home every tensor of a (nested tuple) tree to ``tier``; returns
    the tree and the bytes that moved."""
    if isinstance(tree, (tuple, list)):
        moved, out = 0, []
        for sub in tree:
            x, n = _tree_put(sub, tier)
            out.append(x)
            moved += n
        return tuple(out), moved
    if memspace.tier_of(tree) == tier:
        return tree, 0
    # the cache's placement is the serving loop's own, with no fallback
    # path: a session's injected transfer faults never fire here
    return memspace.put(tree, tier, check=False), memspace.nbytes(tree)


class Server:
    """Batched greedy/temperature decoding over one model replica."""

    def __init__(self, model: Model, params, scfg: ServeConfig,
                 device=None):
        self.model = model
        self.scfg = scfg
        self.params = params
        self.device = memspace.resolve_device(device)
        self.space = memspace.for_device(self.device)
        self.stats = ServeStats()
        self._gen = torch.Generator(device=self.device).manual_seed(
            scfg.seed)

    # ------------------------------------------------------------------ #
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _decode_step(self, tok, cache, pos: int):
        logits, _, cache = self.model.forward(self.params, tok, cache=cache,
                                              cache_pos=pos)
        logits = logits[:, -1, :]
        if self.scfg.temperature > 0:
            probs = torch.softmax(logits / self.scfg.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=self._gen)
        else:
            tok = torch.argmax(logits, dim=-1)[:, None]
        return tok, cache

    # ------------------------------------------------------------------ #
    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """Run the prompt, building the cache on the HOST tier (first
        touch by the CPU side, like the paper's malloc'd matrices)."""
        with memspace.installed(self.space), torch.no_grad():
            tokens = tokens.to(self.device)
            b, _ = tokens.shape
            t0 = time.perf_counter()
            cache = self.model.init_cache(b, self.scfg.max_len,
                                          self.scfg.cache_dtype,
                                          device=self.device)
            if self.scfg.offload_policy == "pinned":
                cache, _ = _tree_put(cache, DEVICE)     # born device-side
            else:
                # CPU-side first touch: the cache starts host-resident...
                cache, _ = _tree_put(cache, HOST)
                # ...and the prefill is its first device use: under DFU
                # THE one migration, under memcopy the first round trip
                cache, moved = _tree_put(cache, DEVICE)
                self.stats.bytes_host_to_dev += moved
                self.stats.migrations += int(
                    self.scfg.offload_policy == "dfu")
            logits, _, cache = self.model.forward(
                self.params, tokens, cache=cache, cache_pos=0)
            if self.scfg.offload_policy == "memcopy":
                cache, moved = _tree_put(cache, HOST)
                self.stats.bytes_dev_to_host += moved
            next_tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
            del logits
            self._sync()
            self.stats.prefill_s += time.perf_counter() - t0
        return next_tok, cache

    def decode(self, tok: torch.Tensor, cache, start_pos: int,
               n_tokens: int) -> Tuple[torch.Tensor, Any]:
        """Generate ``n_tokens``; cache placement per the policy."""
        policy = self.scfg.offload_policy
        outs = []
        with memspace.installed(self.space), torch.no_grad():
            tok = tok.to(self.device)
            t0 = time.perf_counter()
            for i in range(n_tokens):
                pos = start_pos + i
                if policy == "dfu":
                    # first device use migrates; later steps are hits
                    tiers = {memspace.tier_of(x) for x in _leaves(cache)}
                    if HOST in tiers:
                        cache, moved = _tree_put(cache, DEVICE)
                        self.stats.bytes_host_to_dev += moved
                        self.stats.migrations += 1
                    else:
                        self.stats.cache_reuses += 1
                elif policy == "memcopy":
                    cache, moved = _tree_put(cache, DEVICE)
                    self.stats.bytes_host_to_dev += moved
                tok, cache = self._decode_step(tok, cache, pos)
                if policy == "memcopy":
                    cache, moved = _tree_put(cache, HOST)
                    self.stats.bytes_dev_to_host += moved
                else:
                    self.stats.cache_reuses += int(policy == "pinned")
                outs.append(tok)
            self._sync()
            self.stats.decode_s += time.perf_counter() - t0
        self.stats.tokens += n_tokens * tok.shape[0]
        gen = (torch.cat(outs, dim=1) if outs
               else tok.new_empty((tok.shape[0], 0)))
        return gen, cache

    # ------------------------------------------------------------------ #
    def generate(self, prompt: torch.Tensor, n_tokens: int) -> torch.Tensor:
        tok, cache = self.prefill(prompt)
        gen, _ = self.decode(tok, cache, prompt.shape[1], n_tokens - 1)
        return torch.cat([tok, gen], dim=1)
