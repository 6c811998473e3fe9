"""Running value normalizer (reference ``onpolicy/utils/valuenorm.py:
12-99``), port of ``learner/valuenorm.py``: pure functions over an explicit
state.

    update(x):   EMA of mean and mean-square with beta=0.99999, plus a
                 debiasing term, over the flattened batch axes
    var = clamp(E[x^2] - E[x]^2, min=1e-2), mean debiased by clamp(eps=1e-5)
    normalize(x) = (x - mean)/sqrt(var);  denormalize its inverse
``vn_normalize`` and ``vn_denormalize`` also take a PopArt state
(``learner/popart.py``), as in the JAX package.
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


def vn_update(state: ValueNormState, x: Tensor) -> ValueNormState:
    """A new state from a batch; stats over the first axis of the (-1, 1)
    batch (norm_axes=1, valuenorm.py:60-61)."""
    x2 = x.reshape(-1, x.shape[-1])
    w = state.beta
    return dataclasses.replace(
        state,
        running_mean=state.running_mean * w + x2.mean(dim=0) * (1 - w),
        running_mean_sq=state.running_mean_sq * w + (x2**2).mean(dim=0) * (1 - w),
        debiasing_term=state.debiasing_term * w + (1 - w),
    )


def vn_normalize(state, x: Tensor) -> Tensor:
    if not isinstance(state, ValueNormState):
        from .popart import popart_normalize

        return popart_normalize(state, x)
    mean, var = _stats(state)
    return (x - mean) / torch.sqrt(var)


def vn_denormalize(state, x: Tensor) -> Tensor:
    if not isinstance(state, ValueNormState):
        from .popart import popart_denormalize

        return popart_denormalize(state, x)
    mean, var = _stats(state)
    return x * torch.sqrt(var) + mean
