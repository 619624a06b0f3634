"""Optimizers of the LM substrate: vanilla SGD (the paper's choice, Alg. 2),
dense AdaGrad, AdamW; and the cosine schedule.

The reference's protocol (``repro.optim.optimizers``, optax-like):

  opt = adamw(lr)
  state = opt.init(params)
  updates, state = opt.update(grads, state, params)
  params = tree_map(lambda p, u: p + u, params, updates)

with one difference: ``update`` writes the new moments into the state's
tensors in place and returns that state (a copy a step would hold two
AdamW states at once: 15 GB at internlm2-1.8b). Each in-place update is
the reference's expression, with the same roundings. States are plain
trees of tensors (AdamW's a dict ``{"mu", "nu", "count"}``), so they
checkpoint like the params. (The DLRM path's row-wise sparse optimizers
are ``parallel.updates``.)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map

Params = Any


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], Tuple[Params, Any]]
    name: str = ""


def _in_place(fn, state: Params, *trees: Params) -> Params:
    """``state_leaf.copy_(fn(state_leaf, *leaves))`` over the trees."""
    for s, *xs in zip(tree_leaves(state), *map(tree_leaves, trees)):
        s.copy_(fn(s, *xs))
    return state


# ---------------------------------------------------------------------------
def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """Paper Alg. 2 vanilla SGD (momentum=0 default for paper-faithfulness)."""
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params=None):
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g, grads), state
        _in_place(lambda m, g: momentum * m + g, state, grads)
        return tree_map(lambda m: -lr * m, state), state

    return Optimizer(init, update, f"sgd(lr={lr})")


def adagrad(lr: float, eps: float = 1e-8) -> Optimizer:
    """Dense AdaGrad."""
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, acc, params=None):
        _in_place(lambda a, g: a + g.square(), acc, grads)
        updates = tree_map(lambda g, a: -lr * g * torch.rsqrt(a + eps),
                           grads, acc)
        return updates, acc

    return Optimizer(init, update, f"adagrad(lr={lr})")


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          lr_schedule: Optional[Callable[[torch.Tensor],
                                         torch.Tensor]] = None
          ) -> Optimizer:
    """AdamW with bias correction and decoupled weight decay (``weight_decay
    * p`` in the update), with an optional schedule (takes the int step,
    returns the lr scale)."""
    def init(params):
        leaf = tree_leaves(params)[0]
        return {"mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=leaf.device)}

    def update(grads, state, params):
        count = state["count"] + 1
        _in_place(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
        _in_place(lambda n, g: b2 * n + (1 - b2) * g.square(), state["nu"],
                  grads)
        t = count.float()
        c1 = 1 - torch.pow(b1, t)
        c2 = 1 - torch.pow(b2, t)
        step_lr = lr * (lr_schedule(count) if lr_schedule is not None
                        else 1.0)

        def upd(m, n, p):
            mhat = m / c1
            nhat = n / c2
            return -step_lr * (mhat / (torch.sqrt(nhat) + eps)
                               + weight_decay * p)
        updates = tree_map(upd, state["mu"], state["nu"], params)
        state["count"] = count
        return updates, state

    return Optimizer(init, update, f"adamw(lr={lr})")


def cosine_schedule(warmup: int, total: int, min_frac: float = 0.1):
    """Linear warmup over ``warmup`` steps, then a cosine from 1 down to
    ``min_frac`` at ``total``."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = s / max(warmup, 1)
        prog = ((s - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return schedule
