"""Deterministic, shardable, exactly resumable token pipeline.

The counterpart of ``repro/data/pipeline.py``: the batch for (step,
shard) is a pure function of the seed, so restart needs only the step
counter and re-sharding only changes which shard a host asks for.
Synthetic text is Zipf-distributed token ids (the CDF from numpy, a
uniform draw through ``searchsorted``) with an EOS at each position with
probability ``1 / doc_len``.

The reference draws with ``jax.random`` (threefry), whose bits the port
cannot reproduce without JAX.  Here each batch comes from a CPU
``torch.Generator`` seeded from (seed, step * num_shards + shard), the
reference's fold-in value, through numpy's ``SeedSequence``: the same
distribution and the same purity, other tokens.  Parity tests feed both
packages the same numpy batches instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    doc_len: int = 512
    zipf_a: float = 1.2
    eos_id: int = 0


class TokenPipeline:
    """(step, shard) -> {"tokens", "labels"} (int64, on the CPU), with
    shard the data-slice id."""

    def __init__(self, cfg: DataConfig, num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError(f"global_batch {cfg.global_batch} is not a "
                             f"multiple of num_shards {num_shards}")
        self.cfg = cfg
        self.num_shards = num_shards
        self.shard_batch = cfg.global_batch // num_shards
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_a)
        self._cdf = torch.from_numpy((np.cumsum(w) / w.sum()).astype(
            np.float32))

    def _generator(self, step: int, shard: int) -> torch.Generator:
        idx = step * self.num_shards + shard
        seed = np.random.SeedSequence((self.cfg.seed, idx)).generate_state(
            1, np.uint64)[0]
        return torch.Generator().manual_seed(int(seed) & (2 ** 63 - 1))

    def batch(self, step: int, shard: int = 0) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        gen = self._generator(step, shard)
        shape = (self.shard_batch, cfg.seq_len + 1)
        u = torch.rand(shape, generator=gen)
        toks = torch.searchsorted(self._cdf, u).clamp_(0, cfg.vocab - 1)
        eos = torch.rand(shape, generator=gen) < (1.0 / cfg.doc_len)
        toks = torch.where(eos, cfg.eos_id, toks)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def global_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """All shards concatenated (single-host convenience)."""
        parts = [self.batch(step, s) for s in range(self.num_shards)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def iter_from(self, step: int, shard: int = 0
                  ) -> Iterator[Dict[str, torch.Tensor]]:
        """Resume-from-step iterator (what restart uses)."""
        s = step
        while True:
            yield self.batch(s, shard)
            s += 1
