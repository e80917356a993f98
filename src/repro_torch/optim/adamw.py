"""AdamW with decoupled weight decay over the leaves of a parameter tree.

The counterpart of ``repro/optim/adamw.py``, with its arithmetic in its
order: float32 moments whatever the parameters' dtype, a global-norm
clip, bias correction from the step count, weight decay on every leaf
(norm weights and biases included, as the reference decays them).  The
state's moments are lists in the parameters' flatten order
(:func:`repro_torch.tree.leaves`), so a checkpoint of the state holds the
reference's leaves in the reference's order.

Where the reference returns new trees, ``update`` writes the new values
into the parameters and moments in place (under ``torch.no_grad``) and
returns them: the trainer holds one copy of each, not two.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.tree import leaves


class OptState(NamedTuple):
    step: torch.Tensor              # int32, 0-d
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g^2), in float32, summed leaf by
    leaf in order as the reference's Python ``sum`` does.  An empty leaf
    adds nothing and is passed over: on a mesh its sum would be a partial
    sum over the mesh dims it is split on, and cost a collective."""
    total = None
    for g in grads:
        if g.numel() == 0:
            continue
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    if total is None:               # no leaf holds a value
        return torch.zeros((), dtype=torch.float32,
                           device=grads[0].device if grads else None)
    return torch.sqrt(total)


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1.0e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> OptState:
        ps = leaves(params)
        zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in ps]
        return OptState(
            step=torch.zeros((), dtype=torch.int32,
                             device=ps[0].device if ps else None),
            mu=zeros, nu=[z.clone() for z in zeros])

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: OptState, params,
               lr) -> Tuple[object, OptState]:
        """One step: ``grads`` in the parameters' leaf order, ``lr`` a
        float32 0-d tensor (or a float).  Returns (params, state), both
        updated in place."""
        step = state.step + 1
        if self.grad_clip > 0:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
            grads = [g * scale for g in grads]
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()
        for p, g, m, v in zip(leaves(params), grads, state.mu, state.nu):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            delta = delta + self.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
        return params, OptState(step=step, mu=state.mu, nu=state.nu)
