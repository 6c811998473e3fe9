"""Running value normalizer state (reference ``onpolicy/utils/valuenorm.py:
12-99``), port of the parts of ``learner/valuenorm.py`` the rollout reads.

    var = clamp(E[x^2] - E[x]^2, min=1e-2), mean debiased by clamp(eps=1e-5)
    denormalize(x) = x * sqrt(var) + mean
The update and normalize halves come with training.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class ValueNormState:
    running_mean: Tensor  # (1,)
    running_mean_sq: Tensor  # (1,)
    debiasing_term: Tensor  # ()
    beta: float = 0.99999
    epsilon: float = 1e-5


def vn_init(dtype=torch.float32, device=None) -> ValueNormState:
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return ValueNormState(running_mean=z(1), running_mean_sq=z(1), debiasing_term=z())


def _stats(state: ValueNormState):
    d = torch.clamp(state.debiasing_term, min=state.epsilon)
    mean = state.running_mean / d
    mean_sq = state.running_mean_sq / d
    var = torch.clamp(mean_sq - mean**2, min=1e-2)
    return mean, var


def vn_denormalize(state: ValueNormState, x: Tensor) -> Tensor:
    mean, var = _stats(state)
    return x * torch.sqrt(var) + mean
