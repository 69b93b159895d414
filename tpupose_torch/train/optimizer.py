"""The reference trainer's optimizer (port of
``tpupose/train/optimizer.py``): Chainer's Adam, the x1/4 gradient scale on
12 stem layers, the 10-layer stem freeze and the LR drops.

* ``ChainerAdam`` applies ``alpha_t * m / (sqrt(v) + eps)`` with
  ``alpha_t = sqrt(1 - b2^t) / (1 - b1^t)``, Chainer's rule.
  ``torch.optim.Adam`` divides by ``sqrt(v_hat) + eps`` instead, an
  effective eps ``sqrt(1 - b2^t)`` times smaller (~31x at step 1), so it
  does not serve.
* Each param group carries a ``grad_scale`` (applied to the raw gradient
  before Adam, as Chainer's ``GradientScaling`` hook) and a
  ``start_step``: the group takes no update while ``count < start_step``,
  and its moments and its own bias-correction count ``t`` stay zero until
  then (Chainer's ``disable_update``), so its first live update has
  ``t = 1``.
* The learning rate is a piecewise-constant schedule of the optimizer's
  global step count: ``lr * factor^k`` once the count has reached ``k``
  of ``lr_drop_steps``, in float32 as optax computes it.

Only ``posenet`` gets the stem scale and freeze, as in the reference.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

from tpupose_torch.config import TrainConfig

GRAD_SCALE_LAYERS = (
    "conv1_1", "conv1_2", "conv2_1", "conv2_2",
    "conv3_1", "conv3_2", "conv3_3", "conv3_4",
    "conv4_1", "conv4_2", "conv4_3_CPM", "conv4_4_CPM",
)
FREEZE_LAYERS = (
    "conv1_1", "conv1_2", "conv2_1", "conv2_2",
    "conv3_1", "conv3_2", "conv3_3", "conv3_4",
    "conv4_1", "conv4_2",
)


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], np.float32]:
    """Step count -> float32 learning rate: 1e-4, 1e-5 from step 100k,
    1e-6 from step 200k (optax's ``piecewise_constant_schedule``)."""
    drops = sorted(cfg.lr_drop_steps)
    factor = np.float32(cfg.lr_drop_factor)

    def schedule(count: int) -> np.float32:
        v = np.float32(cfg.lr)
        for boundary in drops:
            if count >= boundary:
                v = np.float32(factor * v)
        return v

    return schedule


class ChainerAdam(torch.optim.Optimizer):
    """Adam with Chainer's update rule over param groups that each take a
    ``grad_scale`` and a ``start_step`` (see the module docstring).  Each
    group counts its steps (``count``) and its live Adam steps (``t``);
    both are saved by ``state_dict``."""

    def __init__(self, params: Iterable, lr_schedule: Callable[[int], float],
                 betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(betas=tuple(betas), eps=eps,
                                      grad_scale=1.0, start_step=0,
                                      count=0, t=0))
        self.lr_schedule = lr_schedule
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {"exp_avg": torch.zeros_like(p),
                                 "exp_avg_sq": torch.zeros_like(p)}

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ChainerAdam.step takes no closure")
        for group in self.param_groups:
            count = group["count"]
            group["count"] = count + 1
            if count < group["start_step"]:
                continue  # frozen: no update, moments and t untouched
            params = group["params"]
            grads = [p.grad for p in params]
            if group["grad_scale"] != 1.0:
                grads = torch._foreach_mul(grads, group["grad_scale"])
            b1, b2 = group["betas"]
            m = [self.state[p]["exp_avg"] for p in params]
            v = [self.state[p]["exp_avg_sq"] for p in params]
            # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
            g2 = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(g2, 1 - b2)
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, g2)
            group["t"] += 1
            t = np.float32(group["t"])
            one = np.float32(1.0)
            alpha_t = (np.sqrt(one - np.float32(b2) ** t)
                       / (one - np.float32(b1) ** t))
            denom = torch._foreach_sqrt(v)
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_mul(m, float(alpha_t))
            torch._foreach_div_(upd, denom)
            torch._foreach_mul_(upd, float(-self.lr_schedule(count)))
            torch._foreach_add_(params, upd)


def _stem_layer(name: str, layers) -> bool:
    parts = name.split(".")
    return len(parts) >= 2 and parts[0] == "stem" and parts[1] in layers


def param_groups(model: nn.Module, cfg: TrainConfig, arch: str):
    """The groups of the reference trainer: for ``posenet`` the frozen
    stem (scaled, delayed), the two CPM adapters (scaled) and the rest;
    one group for the crop nets."""
    named = list(model.named_parameters())
    if arch != "posenet":
        return [{"params": [p for _, p in named]}]
    frozen = [p for n, p in named if _stem_layer(n, FREEZE_LAYERS)]
    scaled = [p for n, p in named if _stem_layer(n, GRAD_SCALE_LAYERS)
              and not _stem_layer(n, FREEZE_LAYERS)]
    rest = [p for n, p in named if not _stem_layer(n, GRAD_SCALE_LAYERS)]
    return [
        {"params": frozen, "grad_scale": cfg.stem_grad_scale,
         "start_step": cfg.stem_freeze_steps},
        {"params": scaled, "grad_scale": cfg.stem_grad_scale},
        {"params": rest},
    ]


def make_optimizer(model: nn.Module, cfg: TrainConfig,
                   arch: str = "posenet") -> ChainerAdam:
    """The reference trainer's optimizer over ``model``'s parameters."""
    return ChainerAdam(param_groups(model, cfg, arch),
                       make_lr_schedule(cfg),
                       betas=(cfg.adam_beta1, cfg.adam_beta2),
                       eps=cfg.adam_eps)
