"""Masked categorical action distribution (port of ``models/distributions.py``).

Mirrors the reference's ``Categorical``/``FixedCategorical``
(onpolicy/algorithms/utils/distributions.py:14-28, 55-89): unavailable
actions get their logit forced to the dtype minimum (a large finite
negative, so entropy's p*log p terms stay exactly zero instead of NaN).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def mask_logits(logits: Tensor, available_actions: Tensor | None) -> Tensor:
    if available_actions is None:
        return logits
    neg = torch.finfo(logits.dtype).min
    return torch.where(available_actions == 0, neg, logits)


def log_probs(logits: Tensor, actions: Tensor) -> Tensor:
    """Log prob of integer actions; actions (..., 1) -> (..., 1)."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, actions.to(torch.long))


def entropy(logits: Tensor) -> Tensor:
    """Categorical entropy, (...,): -sum(p * logp), p == 0 terms zero."""
    logp = torch.log_softmax(logits, dim=-1)
    return -(logp.exp() * logp).sum(dim=-1)


def mode(logits: Tensor) -> Tensor:
    return logits.argmax(dim=-1, keepdim=True)


def sample(gen: torch.Generator, logits: Tensor) -> Tensor:
    """One categorical draw per row, by the Gumbel-max rule (as
    ``jax.random.categorical``); (..., A) -> (..., 1) long."""
    tiny = torch.finfo(logits.dtype).tiny
    u = torch.rand(logits.shape, generator=gen, dtype=logits.dtype, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return (logits + gumbel).argmax(dim=-1, keepdim=True)
