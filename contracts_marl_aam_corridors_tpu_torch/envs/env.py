"""User-facing environment API on a batch of envs: reset, and step with
auto-reset (port of ``envs/env.py``).

The env batch lives on the device as one ``EnvState`` of batched tensors and
one step advances all envs in lockstep.  Auto-reset replicates the
reference worker's "reset when all agents are done, return the fresh
observation" (env_wrappers.py:866-870).
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from . import corridor, reset as reset_mod
from .types import EnvParams, EnvState, TimeStep, map_state


def _select_state(pred: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Per-field ``where(pred, a, b)`` with the (B,) ``pred`` broadcast."""

    def sel(x, y):
        return torch.where(pred.reshape(pred.shape + (1,) * (x.ndim - 1)), x, y)

    return map_state(sel, a, b)


def reset(
    params: EnvParams,
    num_envs: int,
    gen: torch.Generator,
    device=None,
    dtype=torch.float32,
) -> tuple[EnvState, TimeStep]:
    """Fresh episodes and their first observations, on the card unless
    ``device`` names another.  Reward and done are zeros."""
    device = resolve_device(device)
    state = reset_mod.reset(params, num_envs, gen, device, dtype)
    state, obs, node_obs, adj, agent_id = corridor.reset_outputs(params, state)
    shape = (num_envs, params.num_agents)
    no = torch.zeros(shape, dtype=torch.bool, device=device)
    ts = TimeStep(
        obs=obs,
        agent_id=agent_id,
        node_obs=node_obs,
        adj=adj,
        reward=torch.zeros(shape, dtype=dtype, device=device),
        done=no,
        info={},
        truncated=no,
    )
    return state, ts


def step(
    params: EnvParams, state: EnvState, action_idx: torch.Tensor, gen: torch.Generator,
    hj_data=None,
) -> tuple[EnvState, TimeStep]:
    """One step with auto-reset of every env whose agents are all done.

    Reward/done/info come from the terminal step; obs/node_obs/adj are the
    fresh episode's where an env reset (env_wrappers.py:866-870).
    ``prev_phase`` carries across the reset, like the reference's
    never-cleared ``agent.previous_phase``, and so does v4oct's
    ``frozen_pos``.  A fresh state is drawn for every
    env and selected per env, so the step never waits on the device to learn
    which envs are done.  ``hj_data`` is the HJ table of a heading model's
    safety filter (``corridor.step``).
    """
    state2, ts = corridor.step(params, state, action_idx, gen, hj_data)
    all_done = ts.done.all(dim=1)

    B = action_idx.shape[0]
    fresh = reset_mod.reset(params, B, gen, state.agent_states.device, state.agent_states.dtype)
    # v4oct's stale position cache outlives the episode too (the reference
    # never rebuilds the scenario object; EnvState.frozen_pos)
    fresh = dataclasses.replace(fresh, prev_phase=state2.prev_phase,
                                frozen_pos=state2.frozen_pos)
    fresh, obs_r, node_r, adj_r, _ = corridor.reset_outputs(params, fresh)

    new_state = _select_state(all_done, fresh, state2)
    ts = dataclasses.replace(
        ts,
        obs=torch.where(all_done[:, None, None], obs_r, ts.obs),
        node_obs=torch.where(all_done[:, None, None, None], node_r, ts.node_obs),
        adj=torch.where(all_done[:, None, None], adj_r, ts.adj),
    )
    return new_state, ts
