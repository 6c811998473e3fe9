"""Control-barrier-function safety filtering as closed-form batched ops
(port of ``safety/cbf.py``).

The reference solves a tiny QP per agent per step through cvxpy
(multiagent/safety_filter.py ``cbf_qp``:287-309, 493-505).  The QP has one
linear inequality constraint, so its solution is the analytic projection

    min (u - u_ref)^T W (u - u_ref)  s.t.  a^T u + b >= 0
    u* = u_ref + max(0, -(a^T u_ref + b)) * W^{-1} a / (a^T W^{-1} a)

``di_exp_cbf_filter`` is the double-integrator exponential-CBF handle
(safety_filter.py:436-548) on a batch of envs: states (B, N, 4).

The filters draw nothing.  Each takes an optional ``trace`` dict, which it
fills with its discrete choices, each as ``(choice, gap)``: the gap is how
far the deciding quantity lies from the other choice (for an argmin, the
second-smallest value less the smallest), so that two devices' choices
can be compared and a flip explained.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..config.physics import VehicleConfig

Tensor = torch.Tensor


def cbf_qp_analytic(u_ref: Tensor, a: Tensor, b: Tensor, w_diag: Tensor) -> Tensor:
    """Closed-form single-constraint weighted QP (see module docstring).

    u_ref: (..., m) reference control; a: (..., m) constraint gradient;
    b: (...,) constraint offset; w_diag: (..., m) objective weights.
    A degenerate a (all zero) returns u_ref, matching cvxpy's
    infeasible -> u_ref fallback (safety_filter.py:305-307).
    """
    winv_a = a / w_diag
    denom = (a * winv_a).sum(dim=-1)
    viol = -((a * u_ref).sum(dim=-1) + b)
    lam = torch.where(denom > 1e-12,
                      torch.clamp(viol, min=0.0) / torch.clamp(denom, min=1e-12),
                      torch.zeros_like(denom))
    return u_ref + lam[..., None] * winv_a


def _di_cbf_terms(rel: Tensor, sep: float, rate: float):
    """Barrier value and Lie derivatives of the double integrator's
    exponential CBF (safety_filter.py:470-483); rel = [x_r, y_r, dvx, dvy]
    (ego - other)."""
    x, y, vx, vy = rel.unbind(dim=-1)
    d = torch.clamp(torch.sqrt(x**2 + y**2), min=1e-9)
    ddist = (x * vx + y * vy) / d
    value = ddist + rate * (d - sep)
    lf = rate * ddist + (x * vy - y * vx) ** 2 / d**3
    lg = torch.stack([x / d, y / d, -x / d, -y / d], dim=-1)
    return value, lf, lg


def _di_clip_bounds(vel: Tensor, cfg: VehicleConfig):
    """Per-axis acceleration bounds near the velocity limits
    (safety_filter.py:455-466): a bound collapses to 0 when one more step at
    full acceleration would pass the limit."""
    zero = torch.zeros_like(vel)
    amax = torch.where(vel < cfg.v_max - cfg.dt * cfg.accel_max, zero + cfg.accel_max, zero)
    amin = torch.where(vel > -cfg.v_max - cfg.dt * cfg.accel_min, zero + cfg.accel_min, zero)
    return amin, amax


def masked_others(x: Tensor, active: Optional[Tensor]) -> Tensor:
    """``x`` (..., N, N) with the diagonal, and the columns of inactive
    agents, set to inf: the candidates of each row's neighbour search."""
    n = x.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    x = torch.where(eye, math.inf, x)
    if active is not None:
        x = torch.where(active[..., None, :], x, math.inf)
    return x


def pick_rows(x: Tensor, j: Tensor) -> Tensor:
    """``x[..., n, j[..., n], :]``: row n's entry of its chosen neighbour
    (the JAX package's one-hot product, exact)."""
    idx = j[..., None, None].expand(j.shape + (1, x.shape[-1]))
    return torch.gather(x, -2, idx)[..., 0, :]


def pick_agents(x: Tensor, j: Tensor) -> Tensor:
    """``x[..., j[..., n], :]`` for (..., N, F) per-agent rows."""
    return torch.gather(x, -2, j[..., None].expand(j.shape + (x.shape[-1],)))


def argmin_gap(x: Tensor) -> Tensor:
    """The second-smallest entry of the last axis less the smallest (inf
    where fewer than two are finite)."""
    if x.shape[-1] < 2:
        return torch.full(x.shape[:-1], math.inf, dtype=x.dtype, device=x.device)
    two = torch.topk(x, 2, dim=-1, largest=False).values
    gap = two[..., 1] - two[..., 0]
    return torch.where(torch.isnan(gap), math.inf, gap)


def di_exp_cbf_filter(states: Tensor, actions: Tensor, cfg: VehicleConfig,
                      active: Optional[Tensor] = None, trace: Optional[dict] = None):
    """Exponential-CBF filter for every double-integrator agent of a batch.

    states: (B, N, 4) [x, y, vx, vy]; actions: (B, N, 2) [ax, ay].
    Returns (filtered_actions, filtered_flags, action_diff,
    min_agent_index), as ``DoubleIntegratorSafetyHandleWithExponentialCBF
    .apply_safety_filter`` (safety_filter.py:507-548) per ego agent: pick
    the other agent of least CBF value (the first on a tie, and agent 0 of
    a row with no candidate); if the nearest other agent is within
    coordination range, project [u_ego, u_other] onto the constraint and
    take the ego half; clip near the velocity bounds.
    """
    rel = states[..., :, None, :] - states[..., None, :, :]  # ego - other
    dist = torch.linalg.vector_norm(rel[..., :2], dim=-1)
    value, _, _ = _di_cbf_terms(rel, cfg.separation_distance, cfg.cbf_rate)
    dist_o = masked_others(dist, active)
    value_o = masked_others(value, active)

    min_by_dist = dist_o.min(dim=-1).values
    j = value_o.argmin(dim=-1)  # the min-value neighbour (safety_filter.py:527)
    rel_j = pick_rows(rel, j)
    value_j, lf_j, lg_j = _di_cbf_terms(rel_j, cfg.separation_distance, cfg.cbf_rate)

    u_ref = torch.cat([actions, pick_agents(actions, j)], dim=-1)  # (B, N, 4)
    b = lf_j + cfg.cbf_rate * value_j
    u = cbf_qp_analytic(u_ref, lg_j, b, torch.ones_like(u_ref))

    # the ego half clipped near the velocity bounds; the reference clips with
    # the RELATIVE state's velocity slots (state[2:4] of rel), a quirk kept
    amin_x, amax_x = _di_clip_bounds(rel_j[..., 2], cfg)
    amin_y, amax_y = _di_clip_bounds(rel_j[..., 3], cfg)
    ux = torch.minimum(torch.maximum(u[..., 0], amin_x), amax_x)
    uy = torch.minimum(torch.maximum(u[..., 1], amin_y), amax_y)
    u = torch.cat([ux[..., None], uy[..., None], u[..., 2:]], dim=-1)

    in_range = min_by_dist <= cfg.coordination_range
    diff_full = torch.linalg.vector_norm(u - u_ref, dim=-1)
    filtered = in_range & (diff_full > 1e-4)
    out = torch.where(in_range[..., None], u[..., :2], actions).to(actions.dtype)
    action_diff = torch.linalg.vector_norm(actions - out, dim=-1).to(actions.dtype)
    if trace is not None:
        vel_j = rel_j[..., 2:]
        hi = cfg.v_max - cfg.dt * cfg.accel_max
        lo = -cfg.v_max - cfg.dt * cfg.accel_min
        trace.update(
            neighbour=(j, argmin_gap(value_o)),
            in_range=(in_range, (min_by_dist - cfg.coordination_range).abs()),
            filtered=(filtered, (diff_full - 1e-4).abs()),
            clip_bounds=(torch.cat([vel_j < hi, vel_j > lo], dim=-1),
                         torch.cat([(vel_j - hi).abs(), (vel_j - lo).abs()], dim=-1)),
            applied=in_range)
    return out, filtered, action_diff, j
