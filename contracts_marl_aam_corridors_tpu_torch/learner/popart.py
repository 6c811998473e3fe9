"""PopArt value normalization (reference ``onpolicy/algorithms/utils/
popart.py:7-111``), port of ``learner/popart.py``: the critic's output layer
is rescaled whenever the target statistics update, so its outputs keep
denormalizing to the same returns.

As in the JAX package, the reference's orphaned-parameter bug (its update
wraps the rescaled weight and bias in new ``nn.Parameter`` objects,
popart.py:63-65, so the optimizer stops training ``v_out``) is not
replicated: the rescaling composes with the optimizer step.

Stats follow the reference: EMA mean/mean_sq with beta=0.99999; the rescale
stddev is sqrt(mean_sq - mean^2) clamped at 1e-4 (not debiased,
popart.py:62), while normalize/denormalize use the debiased mean and var
clamped at 1e-2 (popart.py:67-83).
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class PopArtState:
    mean: Tensor  # (1,)
    mean_sq: Tensor  # (1,)
    stddev: Tensor  # (1,)
    debiasing_term: Tensor  # ()
    beta: float = 0.99999
    epsilon: float = 1e-5


def popart_init(dtype=torch.float32, device=None) -> PopArtState:
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return PopArtState(mean=z(1), mean_sq=z(1), stddev=torch.ones(1, dtype=dtype, device=device),
                       debiasing_term=z())


def popart_update(state: PopArtState, x: Tensor):
    """``(new_state, scale, shift_terms)``: the critic's output layer must be
    rescaled as  w' = w*scale, b' = (old_std*b + old_mean - new_mean)/new_std
    (popart.py:52-65)."""
    x2 = x.reshape(-1, x.shape[-1])
    w = state.beta
    new_mean = state.mean * w + x2.mean(dim=0) * (1 - w)
    new_mean_sq = state.mean_sq * w + (x2**2).mean(dim=0) * (1 - w)
    new_std = torch.clamp(torch.sqrt(new_mean_sq - new_mean**2), min=1e-4)
    new_state = dataclasses.replace(
        state, mean=new_mean, mean_sq=new_mean_sq, stddev=new_std,
        debiasing_term=state.debiasing_term * w + (1 - w),
    )
    scale = state.stddev / new_std
    return new_state, scale, (state.stddev, state.mean, new_mean, new_std)


@torch.no_grad()
def rescale_v_out(v_out: torch.nn.Linear, scale: Tensor, shift_terms) -> None:
    """Rescale the critic's output layer in place (``rescale_v_out``)."""
    old_std, old_mean, new_mean, new_std = shift_terms
    v_out.weight.mul_(scale.to(v_out.weight.dtype))
    v_out.bias.copy_((old_std * v_out.bias + old_mean - new_mean) / new_std)


def _debiased(state: PopArtState):
    d = torch.clamp(state.debiasing_term, min=state.epsilon)
    mean = state.mean / d
    mean_sq = state.mean_sq / d
    var = torch.clamp(mean_sq - mean**2, min=1e-2)
    return mean, var


def popart_normalize(state: PopArtState, x: Tensor) -> Tensor:
    mean, var = _debiased(state)
    return (x - mean) / torch.sqrt(var)


def popart_denormalize(state: PopArtState, x: Tensor) -> Tensor:
    mean, var = _debiased(state)
    return x * torch.sqrt(var) + mean
