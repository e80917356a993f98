"""Training loop: microbatched, remat-aware, restartable.

The counterpart of ``repro/train/loop.py``:

* **Microbatch accumulation**: the global batch runs in ``n_micro``
  slices, each slice's float32 gradients added divided by ``n_micro``.
* **Remat** (none / dots / full) wraps the per-microbatch loss in
  ``torch.utils.checkpoint`` (``use_reentrant=False``).  ``full`` saves
  nothing inside it and recomputes the forward in the backward, as
  ``jax.checkpoint`` with ``nothing_saveable``.  ``dots`` is a selective
  checkpoint that saves the outputs of the 2-D gemm operator
  (``gemm.gemm_grad``: every projection) and recomputes the rest, the
  counterpart of ``dots_with_no_batch_dims_saveable``.
* **Gradient compression** (int8 + error feedback, ``optim``).
* **Restart**: atomic async checkpoints every ``ckpt_every`` steps and a
  blocking one at the end; ``Trainer.fit`` resumes from the latest, and
  since a batch is a pure function of the step, the resumed run repeats
  the uninterrupted one.
* **Straggler watchdog**: each step's wall time against the running
  median; slow steps are counted and printed.

The model's products run on ``csrc/gemm.cu`` forward and backward, and
its prefill-shaped attention on ``csrc/flash_attention.cu`` forward
(``kernels/attention.py``: the backward is the plain formulation).

The trainer keeps the reference's float32 master weights
(``Model.init(..., master=True)``): every use casts to ``cfg.dtype``, so
a bf16 config computes in bf16, gradients arrive in float32, and AdamW
updates float32 values, as the reference's ``astype`` at every use does.
A :class:`Trainer` runs on one device: ``device=None`` is the card
(``cuda:0``) and raises without CUDA; ``device="cpu"`` runs on the CPU.
``TrainConfig.unroll_layers`` (the reference's dry-run cost probe) is
accepted and ignored: the port's layer stack is always a Python loop.

The step is the counterpart of the reference's
``jax.jit(make_train_step(...))`` (``loop.py:153``).  On the card a
``Trainer`` captures it in one ``torch.cuda.CUDAGraph``: the microbatch
loop, ``torch.autograd.grad`` through the kernels' operators, remat,
compression, the gradient norm and the in-place AdamW.  Its first step
runs eagerly on a side stream (the warm-up, a real step), the second
captures the step and replays the capture, every later one replays it.
The step count is a 0-d int32 tensor on the device, as the reference
passes ``jnp.asarray(self.step, jnp.int32)``; the batch is copied into
static buffers; the parameters, the moments, the optimizer's step and
the compression residuals are the graph's own buffers, updated in place,
and ``loss``, ``lr``, ``grad_norm`` its static outputs, read as floats
after each step.  A batch of other shapes warms up and captures anew; a
restore copies the checkpoint into the buffers.  The launch counters
count each replay as the captured step's launches (the backward's
included, which autograd launches from its own thread:
``kernels.compat.recording``).  A capture that fails raises: no eager
fallback exists on the card.  The CPU runs the same step
(:meth:`Trainer._update`, the same tensor count and in-place state)
eagerly.  A Python wrapper around the step function sees only the
warm-up and the capture on the card.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.checkpoint import CheckpointStore
from repro_torch.core import memspace
from repro_torch.data import TokenPipeline
from repro_torch.kernels import compat
from repro_torch.models.registry import Model
from repro_torch.models.sharding import shard
from repro_torch.optim import (AdamW, compress_decompress, cosine_schedule,
                               init_compression)
from repro_torch.optim.adamw import global_norm
from repro_torch.tree import leaves


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    peak_lr: float = 3.0e-4
    warmup: int = 20
    n_micro: int = 1
    remat: str = "none"             # none | dots | full
    grad_compress: bool = False
    z_loss: float = 1.0e-4
    log_every: int = 10
    ckpt_every: int = 50
    straggler_factor: float = 3.0
    moe_impl: str = "scatter"
    unroll_layers: bool = False     # accepted, ignored: a Python loop


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_coef: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy over all positions in float32, the max taken
    without a gradient, plus ``z_coef`` times the mean squared
    log-sum-exp (z-loss)."""
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    # resolved before the select: on vocab-sharded logits the gather is
    # partial (the rows other ranks hold), reduced by this constraint
    gold = shard(torch.gather(logits, -1, labels[..., None].long()),
                 "batch", "seq", None)[..., 0]
    ce = torch.mean(lse - gold)
    if z_coef > 0:
        ce = ce + z_coef * torch.mean(torch.square(lse))
    return ce


def _save_projections(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the 2-D gemm operator's outputs, recompute
    everything else (batched products included, as the reference's
    policy keeps only dots without batch dims)."""
    if op is torch.ops.repro_torch.gemm.default and args[0].dim() == 2:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn: Callable, mode: str) -> Callable:
    """The microbatch loss under ``mode``'s checkpoint.  The forward draws
    no random number, so no RNG state is saved for the recompute (reading
    the card's generator state cannot be captured in a graph)."""
    if mode == "none":
        return fn
    if mode == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    if mode == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            preserve_rng_state=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts,
                _save_projections))
    raise ValueError(f"unknown remat mode {mode!r}")


def make_loss(model: Model, tcfg: TrainConfig) -> Callable:
    """The loss of one microbatch, ``(params, tokens, labels, extra) ->``
    a 0-d float32 tensor: cross-entropy with z-loss, plus the MoE layers'
    auxiliary loss."""
    def micro_loss(params, tokens, labels, extra):
        logits, aux, _ = model.forward(params, tokens,
                                       moe_impl=tcfg.moe_impl, **extra)
        return cross_entropy(logits, labels, tcfg.z_loss) + aux

    return micro_loss


def make_train_step(model: Model, tcfg: TrainConfig, opt: AdamW,
                    total_steps: Optional[int] = None):
    """The update ``(params, opt_state, comp_state, batch, step) ->
    (params, opt_state, comp_state, metrics)``.  ``step`` is a host int
    or a 0-d int32 tensor on the parameters' device.  ``params`` is a
    tree of float32 leaves that take a gradient; it and ``opt_state``'s
    moments are updated in place and returned.  ``batch`` holds ``tokens``,
    ``labels`` and the family's stub inputs, on the parameters' device;
    ``metrics`` are 0-d float32 tensors ``loss``, ``lr``, ``grad_norm``."""
    total = total_steps or tcfg.steps
    loss_fn = _remat_wrap(make_loss(model, tcfg), tcfg.remat)

    def train_step(params, opt_state, comp_state, batch: Dict, step):
        tokens, labels = batch["tokens"], batch["labels"]
        extra = {k: v for k, v in batch.items()
                 if k not in ("tokens", "labels")}
        b, nm = tokens.shape[0], tcfg.n_micro
        if b % nm:
            raise ValueError(f"batch {b} is not a multiple of n_micro {nm}")
        ps = leaves(params)
        grads = [None] * len(ps)
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(nm):
            rows = slice(i * b // nm, (i + 1) * b // nm)
            part = loss_fn(params, tokens[rows], labels[rows],
                           {k: v[rows] for k, v in extra.items()})
            got = torch.autograd.grad(part, ps, allow_unused=True)
            with torch.no_grad():
                for j, (p, g) in enumerate(zip(ps, got)):
                    g = (torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                         if g is None else g.float()) / nm
                    grads[j] = g if grads[j] is None else grads[j] + g
                loss = loss + part.detach() / nm
            del part, got
        if tcfg.grad_compress:
            grads, comp_state = compress_decompress(grads, comp_state)
        lr = cosine_schedule(step, peak_lr=tcfg.peak_lr,
                             warmup=tcfg.warmup, total=total).to(
                                 tokens.device)
        gnorm = global_norm(grads)
        params, opt_state = opt.update(grads, opt_state, params, lr)
        return params, opt_state, comp_state, {"loss": loss, "lr": lr,
                                               "grad_norm": gnorm}

    return train_step


@dataclasses.dataclass
class _Captured:
    """One captured train step and its static buffers."""
    graph: Any                  # torch.cuda.CUDAGraph
    batch: Dict[str, torch.Tensor]      # the step's inputs
    metrics: Dict[str, torch.Tensor]    # loss, lr, grad_norm
    record: list                # launch counter moves of one replay


def _fits(static: Dict[str, torch.Tensor], batch: Dict) -> bool:
    return static.keys() == batch.keys() and all(
        (static[k].shape, static[k].dtype) == (v.shape, v.dtype)
        for k, v in batch.items())


class Trainer:
    """Host-side orchestration: data, checkpoints, watchdog, restart."""

    def __init__(self, model: Model, pipeline: TokenPipeline,
                 tcfg: TrainConfig, *, opt: Optional[AdamW] = None,
                 ckpt_dir: Optional[str] = None, seed: int = 0,
                 extra_batch_fn: Optional[Callable[[int], Dict]] = None,
                 device=None):
        self.device = memspace.resolve_device(device)
        self.model = model
        self.pipe = pipeline
        self.tcfg = tcfg
        self.opt = opt or AdamW()
        self.store = CheckpointStore(ckpt_dir) if ckpt_dir else None
        self.extra_batch_fn = extra_batch_fn
        self._step_fn = make_train_step(model, tcfg, self.opt)
        self.params = model.init(
            torch.Generator(device=self.device).manual_seed(seed),
            self.device, master=True)
        self.opt_state = self.opt.init(self.params)
        self.comp_state = init_compression(self.params)
        self.step = 0
        self.step_times: list = []
        self.straggler_events = 0
        self.history: list = []
        #: the step count as the step reads it, a 0-d int32 tensor on the
        #: device (the reference's ``jnp.asarray(self.step, jnp.int32)``)
        self._step_t = torch.zeros((), dtype=torch.int32,
                                   device=self.device)
        #: the card's step: its side stream (None until the warm-up of the
        #: batch's shapes), the capture, the replays so far
        self._stream = None
        self._graph: Optional[_Captured] = None
        self.replays = 0

    # ------------------------------------------------------------------ #
    def _state_tree(self) -> Dict:
        return {"params": self.params, "opt": self.opt_state,
                "comp": self.comp_state}

    def maybe_restore(self) -> bool:
        if self.store is None or self.store.latest_step() is None:
            return False
        tree, manifest = self.store.restore(self._state_tree())
        # the step keeps its state in the Trainer's own tensors (a
        # captured step's buffers on the card)
        with torch.no_grad():
            for dst, src in zip(leaves(self._state_tree()), leaves(tree)):
                dst.copy_(src)
        self.step = manifest["step"]
        return True

    def _update(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One step at the step count tensor, its state kept in the
        Trainer's own tensors: the optimizer's new step count and the
        new compression residuals are copied back into them, so that a
        captured step rewrites its own buffers.  The CPU's step, the
        card's warm-up and the body of its capture."""
        _, opt_state, comp_state, metrics = self._step_fn(
            self.params, self.opt_state, self.comp_state, batch,
            self._step_t)
        with torch.no_grad():
            self.opt_state.step.copy_(opt_state.step)
            for old, new in zip(self.comp_state.residual,
                                comp_state.residual):
                if new is not old:
                    old.copy_(new)
        return metrics

    def _card_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One step on the card: warm up (eager, on the side stream: the
        Trainer's first step), capture and replay (the second), or
        replay.  Returns the step's metrics as device tensors."""
        g = self._graph
        if g is not None and not _fits(g.batch, batch):
            g = self._graph = None      # other shapes: warm up anew
            self._stream = None
        current = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                metrics = self._update(batch)
            current.wait_stream(self._stream)
            return metrics
        if g is None:
            g = self._graph = self._capture(batch)
        for k, v in batch.items():
            g.batch[k].copy_(v)
        g.graph.replay()
        compat.replayed(g.record)
        self.replays += 1
        return g.metrics

    def _capture(self, batch: Dict) -> _Captured:
        """Capture :meth:`_update` on the side stream (``compat.capture``,
        ``thread_local`` mode), its inputs copied into static buffers;
        nothing runs until the first replay.  The counters' moves, the
        backward's included, go into the capture's record."""
        static = {k: v.clone() for k, v in batch.items()}
        # the warm-up's freed blocks go back to the card, where the
        # graph's own pool can take them
        torch.cuda.empty_cache()
        graph, metrics, record = compat.capture(self._update, static,
                                                stream=self._stream)
        return _Captured(graph, static, metrics, record)

    def _watchdog(self, dt: float) -> None:
        self.step_times.append(dt)
        if len(self.step_times) >= 8:
            recent = sorted(self.step_times[-50:])
            med = recent[len(recent) // 2]
            if dt > self.tcfg.straggler_factor * med:
                self.straggler_events += 1
                print(f"[watchdog] step {self.step} took {dt:.3f}s "
                      f"(median {med:.3f}s) — straggler flagged")

    # ------------------------------------------------------------------ #
    def fit(self, steps: Optional[int] = None, verbose: bool = True):
        steps = steps or self.tcfg.steps
        self.maybe_restore()
        while self.step < steps:
            batch = self.pipe.global_batch(self.step)
            if self.extra_batch_fn is not None:
                batch.update(self.extra_batch_fn(self.step))
            batch = {k: v.to(self.device) for k, v in batch.items()}
            t0 = time.perf_counter()
            self._step_t.fill_(self.step)
            if self.device.type == "cuda":
                metrics = self._card_step(batch)
            else:
                metrics = self._update(batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self._watchdog(dt)
            self.step += 1
            self.history.append(metrics)
            if verbose and self.step % self.tcfg.log_every == 0:
                print(f"step {self.step:5d}  loss {metrics['loss']:.4f}  "
                      f"lr {metrics['lr']:.2e}  "
                      f"gnorm {metrics['grad_norm']:.2f}  {dt:.2f}s")
            if (self.store is not None
                    and self.step % self.tcfg.ckpt_every == 0):
                self.store.save(self.step, self._state_tree(),
                                blocking=False)
        if self.store is not None:
            self.store.save(self.step, self._state_tree(), blocking=True)
        return self.history
