"""Optimizer and learning-rate schedule (port of
``multi_speaker_tts_tpu.train.optim``): clip by global norm -> RAdam under
a Noam schedule -> decoupled weight decay scaled by the schedule, computing
what the JAX package's optax chain computes.

RAdam is written out (not ``torch.optim.RAdam``, which adds eps to the
uncorrected second moment's square root): as ``optax.scale_by_radam``, with
bias-corrected moments, eps outside the square root of the corrected second
moment, the rectification applied when rho_t >= 5 and the corrected first
moment alone below it. Every transform's step count starts at 0 and moves
by one an update, so one count serves the chain: the learning rate of an
update is the schedule at the count before it. Updates are returned, not
applied, so a caller can skip a step without touching anything.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_RHO_THRESHOLD = 5.0  # optax.radam's: below it the update is the corrected first moment


def noam_schedule(initial_lr: float, warmup_steps: int):
    """lr(step) = initial * warmup^0.5 * min(step^-0.5, step * warmup^-1.5),
    step floored at 1. Equals ``initial_lr`` at ``step == warmup_steps``;
    f32 arithmetic, as the JAX schedule."""
    scale = np.float32(initial_lr * warmup_steps ** 0.5)

    def schedule(step: int) -> float:
        s = np.float32(max(step, 1))
        return float(scale * min(s ** np.float32(-0.5), s * np.float32(warmup_steps ** -1.5)))

    return schedule


class OptState(NamedTuple):
    count: int  # updates applied so far
    mu: list  # first moments, one f32 tensor per parameter
    nu: list  # second moments


class Optimizer:
    """``make_optimizer``'s chain over a list of parameters (the order fixed
    at :meth:`init`)."""

    def __init__(self, schedule, max_norm: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.schedule, self.max_norm = schedule, max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params) -> OptState:
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return OptState(0, zeros, [z.clone() for z in zeros])

    @torch.no_grad()
    def update(self, grads, state: OptState, params) -> tuple[list, OptState]:
        """(updates to add to the parameters, the next state)."""
        g_norm = global_norm(grads)
        grads = [g.float() for g in grads]
        if not bool(g_norm < self.max_norm):
            grads = [g / g_norm * self.max_norm for g in grads]
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        mu = [(1 - self.b1) * g + self.b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1 - self.b2) * (g * g) + self.b2 * v for g, v in zip(grads, state.nu)]
        count = state.count + 1
        b2t = b2 ** np.float32(count)
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        ro = np.float32(ro_inf) - np.float32(2 * count) * b2t / (np.float32(1) - b2t)
        c1 = np.float32(1) - b1 ** np.float32(count)
        c2 = np.float32(1) - b2 ** np.float32(count)
        if ro >= _RHO_THRESHOLD:
            r = float(np.sqrt((ro - 4) * (ro - 2) * np.float32(ro_inf)
                              / (np.float32((ro_inf - 4) * (ro_inf - 2)) * ro)))
            updates = [r * (m / float(c1)) / (torch.sqrt(v / float(c2)) + self.eps)
                       for m, v in zip(mu, nu)]
        else:
            updates = [m / float(c1) for m in mu]
        lr = self.schedule(state.count)
        updates = [-lr * u for u in updates]
        if self.weight_decay:
            updates = [u - lr * self.weight_decay * p for u, p in zip(updates, params)]
        return updates, OptState(count, mu, nu)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def make_optimizer(hp) -> Optimizer:
    """clip-by-global-norm -> RAdam(Noam schedule) [-> weight decay], from
    ``hp.Train``."""
    tr = hp.Train
    adam = tr.get("ADAM")
    kwargs = dict(b1=adam.Beta1, b2=adam.Beta2, eps=adam.Epsilon) if adam else {}
    return Optimizer(noam_schedule(tr.Learning_Rate.Initial, tr.Learning_Rate.Warmup_Step),
                     tr.Gradient_Norm, weight_decay=tr.get("Weight_Decay", 0.0) or 0.0,
                     **kwargs)

