"""Batched pairwise-distance ops (port of ``ops/distance.py``).

Replaces the reference's O(E^2) Python double loop ``World.calculate_distances``
(multiagent/core.py:600-624) with one tensor computation per batch.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def pairwise_vectors(pos: Tensor) -> Tensor:
    """(..., E, 2) positions -> (..., E, E, 2) deltas pos_i - pos_j."""
    return pos[..., :, None, :] - pos[..., None, :, :]


def pairwise_distances(pos: Tensor) -> Tensor:
    """(..., E, 2) positions -> (..., E, E) Euclidean distances (0 diagonal)."""
    return torch.linalg.vector_norm(pairwise_vectors(pos), dim=-1)


def two_nearest_neighbors(agent_pos: Tensor) -> Tensor:
    """Relative positions of each agent's two nearest other agents.

    The neighbor block of the 19-dim observation (july:1398-1417): others
    sorted by distance ascending (stable, self last), two taken, zeros when
    fewer than two others exist.  Returns (..., N, 4).
    """
    n = agent_pos.shape[-2]
    rel = -pairwise_vectors(agent_pos)  # rel[i, j] = pos_j - pos_i
    dist = torch.linalg.vector_norm(rel, dim=-1)
    eye = torch.eye(n, dtype=torch.bool, device=agent_pos.device)
    dist = dist.masked_fill(eye, float("inf"))
    order = torch.argsort(dist, dim=-1, stable=True)

    def pick(k):
        idx = order[..., k : k + 1, None].expand(*order.shape[:-1], 1, 2)
        return torch.gather(rel, -2, idx)[..., 0, :]

    first = pick(0)
    second = pick(1) if n >= 3 else torch.zeros_like(first)
    return torch.cat([first, second], dim=-1)
