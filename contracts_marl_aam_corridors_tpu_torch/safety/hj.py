"""Hamilton-Jacobi reachability safety filter for the air-taxi model (port
of ``safety/hj.py``).

Counterpart of ``AirTaxiSafetyHandle`` (multiagent/safety_filter.py
:176-309): the HJ value function is a dense 5-D grid over the relative
state [x_r, y_r, dtheta, v_a, v_b] with precomputed gradients, looked up
by multilinear interpolation; the least-restrictive logic (the optimal
evasive control when V < eps, else the CBF-QP) is a ``where`` ladder over
closed forms, on a batch of envs: states (B, N, 4).

The reference loads its value function from
``data/airtaxi_value_function.pkl``, which is not shipped (multiagent/
config.py:32).  ``load_hj_pickle`` reads such a pickle as ``HjDataHandle``
(:154-174) does; ``make_synthetic_airtaxi_hj`` builds a distance-based
stand-in.  Both build the table in numpy, as the JAX package does, and
``HjValueData.to`` puts it on a device in a dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..config.physics import VehicleConfig
from .cbf import argmin_gap, cbf_qp_analytic, masked_others, pick_agents, pick_rows

Tensor = torch.Tensor

EPS_HJ = 0.4  # safety_filter.py:236


@dataclasses.dataclass(frozen=True)
class HjValueData:
    """The value grid, its gradients and the grid's corners."""

    lo: Tensor  # (5,)
    hi: Tensor  # (5,)
    values: Tensor  # grid shape
    grads: Tensor  # grid shape + (5,)
    separation_distance: float = 0.4572

    @classmethod
    def from_numpy(cls, lo, hi, values, grads, separation_distance, device="cpu",
                   dtype=torch.float64) -> "HjValueData":
        conv = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
        return cls(conv(lo), conv(hi), conv(values), conv(grads), separation_distance)

    def to(self, device=None, dtype=None) -> "HjValueData":
        """The table on ``device`` in ``dtype`` (the env's)."""
        conv = lambda t: t.to(device=device, dtype=dtype)
        return dataclasses.replace(self, lo=conv(self.lo), hi=conv(self.hi),
                                   values=conv(self.values), grads=conv(self.grads))


def interpolate(lo: Tensor, hi: Tensor, table: Tensor, x: Tensor) -> tuple[Tensor, Tensor]:
    """Multilinear interpolation on a rectangular grid.

    table: (*grid_shape, ...); trailing dims are interpolated channel-wise.
    x: (..., d).  Returns (value, in_range), where in_range mirrors the
    reference's NaN/exception -> "out of hj range" handling (:195-201).
    The 2^d corners are summed in the JAX package's order: corner c takes
    bit k of c as its offset along axis k, and its weight is the product of
    the axes' factors in axis order.  A corner's offsets are Python
    integers, so the loop moves nothing to the device.
    """
    d = x.shape[-1]
    grid_shape = tuple(table.shape[:d])
    shape = torch.tensor(grid_shape, device=x.device)
    in_range = ((x >= lo) & (x <= hi)).all(dim=-1)
    t = (x - lo) / (hi - lo) * (shape - 1)
    t = torch.minimum(torch.maximum(t, torch.zeros_like(t)), (shape - 1).to(t.dtype))
    i0 = torch.minimum(torch.clamp(torch.floor(t).long(), min=0), shape - 2)
    frac = t - i0
    one_minus = 1.0 - frac

    strides = [int(v) for v in np.cumprod((grid_shape[1:] + (1,))[::-1])[::-1]]
    base = i0[..., 0] * strides[0]
    for k in range(1, d):
        base = base + i0[..., k] * strides[k]
    table_flat = table.reshape((-1,) + tuple(table.shape[d:]))

    out = None
    for corner in range(2**d):
        bits = [(corner >> k) & 1 for k in range(d)]
        factors = [(frac if bit else one_minus)[..., k] for k, bit in enumerate(bits)]
        w = factors[0]
        for f in factors[1:]:
            w = w * f
        val = table_flat[base + sum(b * s for b, s in zip(bits, strides))]
        contrib = w[..., None] * val if val.ndim > w.ndim else w * val
        out = contrib if out is None else out + contrib
    return out, in_range


def relative_state_airtaxi(ego: Tensor, other: Tensor) -> Tensor:
    """The 5-D relative state (safety_filter.py ``get_relative_state``
    :279-285)."""
    dx = other[..., 0] - ego[..., 0]
    dy = other[..., 1] - ego[..., 1]
    dist = torch.sqrt(dx**2 + dy**2)
    ang = torch.atan2(dy, dx)
    x_r = dist * torch.cos(ang - ego[..., 2])
    y_r = dist * torch.sin(ang - ego[..., 2])
    comps = torch.broadcast_tensors(x_r, y_r, other[..., 2] - ego[..., 2], ego[..., 3],
                                    other[..., 3])
    return torch.stack(comps, dim=-1)


def _control_jacobian(rel: Tensor) -> Tensor:
    """B(x) of the Air4d relative dynamics (safety_filter.py:54-60);
    controls [w_a, w_b, a_a, a_b].  (..., 5, 4)"""
    z = torch.zeros_like(rel[..., 0])
    one = torch.ones_like(z)
    return torch.stack(
        [
            torch.stack([rel[..., 1], z, z, z], -1),
            torch.stack([-rel[..., 0], z, z, z], -1),
            torch.stack([-one, one, z, z], -1),
            torch.stack([z, z, one, z], -1),
            torch.stack([z, z, z, one], -1),
        ],
        dim=-2,
    )


def _open_loop(rel: Tensor) -> Tensor:
    """f(x) (safety_filter.py:42-51)."""
    th, va, vb = rel[..., 2], rel[..., 3], rel[..., 4]
    z = torch.zeros_like(th)
    return torch.stack([-va + vb * torch.cos(th), vb * torch.sin(th), z, z, z], dim=-1)


def _optimal_control(rel: Tensor, grad: Tensor, cfg: VehicleConfig,
                     direction: Optional[Tensor] = None) -> Tensor:
    """Bang-bang evasive control from the value gradient
    (safety_filter.py ``optimal_control_and_disturbance``:64-85, mode
    'max'), with the box shrunk at the speed bounds."""
    if direction is None:
        direction = torch.einsum("...i,...ij->...j", grad, _control_jacobian(rel))
    w, amin, amax = cfg.angular_rate_max, cfg.accel_min, cfg.accel_max
    lo = rel.new_tensor([-w, -w, amin, amin]).expand(rel.shape[:-1] + (4,))
    hi = rel.new_tensor([w, w, amax, amax]).expand(rel.shape[:-1] + (4,))
    zero = torch.zeros_like(rel[..., 0])
    # the box shrinks at the speed bounds (ego accel slot 2, other slot 3)
    lo = torch.stack([lo[..., 0], lo[..., 1],
                      torch.where(rel[..., 3] <= cfg.v_min, zero, lo[..., 2]),
                      torch.where(rel[..., 4] <= cfg.v_min, zero, lo[..., 3])], dim=-1)
    hi = torch.stack([hi[..., 0], hi[..., 1],
                      torch.where(rel[..., 3] >= cfg.v_max, zero, hi[..., 2]),
                      torch.where(rel[..., 4] >= cfg.v_max, zero, hi[..., 3])], dim=-1)
    return torch.where(direction > 0, hi, lo)


def _clip_acc(acc: Tensor, v: Tensor, cfg: VehicleConfig) -> Tensor:
    """Acceleration clipped near the speed bounds
    (``clip_ctrl_with_valid_control_bound``)."""
    zero = torch.zeros_like(acc)
    amax = torch.where(v < cfg.v_max - cfg.dt * cfg.accel_max, zero + cfg.accel_max, zero)
    amin = torch.where(v > cfg.v_min - cfg.dt * cfg.accel_min, zero + cfg.accel_min, zero)
    return torch.minimum(torch.maximum(acc, amin), amax)


def airtaxi_hj_filter(states: Tensor, actions: Tensor, hj: HjValueData, cfg: VehicleConfig,
                      active: Optional[Tensor] = None, trace: Optional[dict] = None):
    """Least-restrictive HJ filter for every air-taxi agent of a batch
    (``apply_safety_filter``, safety_filter.py:203-263).

    states: (B, N, 4) [x, y, theta, v]; actions: (B, N, 2) [w, a].
    Returns (filtered_actions, filtered_flags, action_diff,
    min_value_index).  ``trace``: see ``safety/cbf.py``.
    """
    n = states.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=states.device)
    rel = relative_state_airtaxi(states[..., :, None, :], states[..., None, :, :])  # (B,N,N,5)
    dist = torch.linalg.vector_norm(states[..., None, :, :2] - states[..., :, None, :2], dim=-1)
    values, in_range = interpolate(hj.lo, hj.hi, hj.values, rel)
    values = torch.where(in_range, values, torch.inf)

    dist_o = masked_others(dist, active)
    values_o = masked_others(values, active)
    min_by_dist = dist_o.min(dim=-1).values
    j = values_o.argmin(dim=-1)

    rel_j = pick_rows(rel, j)
    value_j = values_o.min(dim=-1).values  # the value at j (inf-safe)
    range_j = pick_rows((in_range & ~eye)[..., None], j)[..., 0]
    grad_j, _ = interpolate(hj.lo, hj.hi, hj.grads, rel_j)

    u_ref = torch.cat([actions, pick_agents(actions, j)], dim=-1)  # [w_a, a_a, w_b, a_b]
    # the HJ control layout [w_a, w_b, a_a, a_b]
    u_ref_hj = torch.stack([u_ref[..., 0], u_ref[..., 2], u_ref[..., 1], u_ref[..., 3]], dim=-1)

    # branch 1: the optimal evasive control when V < eps (safety_filter.py:250-252)
    jac = _control_jacobian(rel_j)
    a_con = torch.einsum("...i,...ij->...j", grad_j, jac)
    u_opt = _optimal_control(rel_j, grad_j, cfg, direction=a_con)

    # branch 2: the CBF-QP (cbf_qp:287-309), objective weights by x_r's sign
    b_con = (grad_j * _open_loop(rel_j)).sum(dim=-1) + cfg.cbf_rate * torch.where(
        torch.isfinite(value_j), value_j, torch.zeros_like(value_j))
    w_neg = states.new_tensor([100.0, 10.0, 10.0, 1.0])
    w_pos = states.new_tensor([10.0, 1.0, 100.0, 10.0])
    behind = rel_j[..., 0] < 0
    w = torch.where(behind[..., None], w_neg, w_pos)
    u_qp = cbf_qp_analytic(u_ref_hj, a_con, b_con, w)
    # the QP path clips the angular rates (safety_filter.py:307-309)
    wmax = cfg.angular_rate_max
    u_qp = torch.cat([torch.clamp(u_qp[..., :2], -wmax, wmax), u_qp[..., 2:]], dim=-1)

    evasive = value_j < EPS_HJ
    u = torch.where(evasive[..., None], u_opt, u_qp)
    u = torch.stack([u[..., 0], u[..., 1], _clip_acc(u[..., 2], rel_j[..., 3], cfg),
                     _clip_acc(u[..., 3], rel_j[..., 4], cfg)], dim=-1)

    in_coord = min_by_dist <= cfg.coordination_range
    apply = in_coord & range_j
    diff_full = torch.linalg.vector_norm(u - u_ref_hj, dim=-1)
    filtered = apply & (diff_full > 1e-4)
    ego_u = torch.stack([u[..., 0], u[..., 2]], dim=-1)  # back to [w_a, a_a]
    out = torch.where(apply[..., None], ego_u, actions).to(actions.dtype)
    action_diff = torch.linalg.vector_norm(actions - out, dim=-1).to(actions.dtype)
    if trace is not None:
        trace.update(
            neighbour=(j, argmin_gap(values_o)),
            evasive=(evasive, (value_j - EPS_HJ).abs()),
            in_range=(in_coord, (min_by_dist - cfg.coordination_range).abs()),
            filtered=(filtered, (diff_full - 1e-4).abs()),
            bang_bang=(a_con > 0, a_con.abs()),
            qp_weights=(behind, rel_j[..., 0].abs()),
            applied=apply)
    return out, filtered, action_diff, j


def make_synthetic_airtaxi_hj(cfg: VehicleConfig, shape: Sequence[int] = (21, 21, 9, 5, 5),
                              span: float = 3.0, device="cpu",
                              dtype=torch.float64) -> HjValueData:
    """Distance-based stand-in value function:
    V(x) = ||[x_r, y_r]|| - separation_distance (positive = safe)."""
    lo = np.array([-span, -span, -np.pi, cfg.v_min, cfg.v_min])
    hi = np.array([span, span, np.pi, cfg.v_max, cfg.v_max])
    axes = [np.linspace(lo[k], hi[k], shape[k]) for k in range(5)]
    mesh = np.meshgrid(*axes, indexing="ij")
    values = np.sqrt(mesh[0] ** 2 + mesh[1] ** 2) - cfg.separation_distance
    grads = np.stack(np.gradient(values, *[ax for ax in axes]), axis=-1)
    return HjValueData.from_numpy(lo, hi, values, grads, cfg.separation_distance, device, dtype)


def load_hj_pickle(path: str, target_separation_distance: float, device="cpu",
                   dtype=torch.float64) -> HjValueData:
    """``HjDataHandle`` (safety_filter.py:154-174): the stored values negated
    (they are stored negative inside the safe set), shifted by the
    separation change, gradients precomputed.  The pickle holds
    ``info["separation_distance"]``, ``grid_meta_data`` (a dict or an object
    with ``lo`` and ``hi``) and ``values``; the hj_reachability package is
    not needed when those are plain arrays.  Unpickling runs what the file
    holds: load only a table you trust."""
    import pickle

    with open(path, "rb") as f:
        data = pickle.load(f)
    original = data.info["separation_distance"]
    shift = target_separation_distance - original
    meta = data.grid_meta_data
    lo = np.asarray(meta["lo"] if isinstance(meta, dict) else meta.lo)
    hi = np.asarray(meta["hi"] if isinstance(meta, dict) else meta.hi)
    values = -np.asarray(data.values) - shift
    axes = [np.linspace(lo[k], hi[k], values.shape[k]) for k in range(values.ndim)]
    grads = np.stack(np.gradient(values, *axes), axis=-1)
    return HjValueData.from_numpy(lo, hi, values, grads, target_separation_distance, device,
                                  dtype)
