"""Rollout storage and returns (reference ``GraphReplayBuffer``,
onpolicy/utils/graph_buffer.py:19-366), port of ``learner/buffer.py``.

The whole rollout is stacked into one buffer of (T+1, B, N, ...) tensors.
``adj`` is stored once per env (the reference stores a copy per agent).

Mask semantics (graph_mpe_runner.py:384-428):
    masks[t+1]        0 where agent done at t (rnn reset signal)
    active_masks[t+1] 0 where agent done, EXCEPT all-done envs reset to 1
                      (a fresh auto-reset episode started)
    rnn_states[t+1]   zeroed where done
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .valuenorm import ValueNormState, vn_denormalize

Tensor = torch.Tensor


@dataclasses.dataclass
class RolloutBuffer:
    """Shapes: T = episode_length, B = n envs, N = agents, E = entities."""

    share_obs: Tensor  # (T+1, B, N, N*obs)
    obs: Tensor  # (T+1, B, N, obs)
    node_obs: Tensor  # (T+1, B, N, E, F)
    adj: Tensor  # (T+1, B, E, E)
    agent_id: Tensor  # (T+1, B, N, 1) long
    rnn_states: Tensor  # (T+1, B, N, rN, H)
    rnn_states_critic: Tensor  # (T+1, B, N, rN, H)
    actions: Tensor  # (T, B, N, 1)
    action_log_probs: Tensor  # (T, B, N, 1)
    value_preds: Tensor  # (T+1, B, N, 1)
    returns: Tensor  # (T+1, B, N, 1)
    rewards: Tensor  # (T, B, N, 1)
    masks: Tensor  # (T+1, B, N, 1)
    active_masks: Tensor  # (T+1, B, N, 1)
    available_actions: Tensor  # (T+1, B, N, A)
    # bad_masks[t+1] = 0 where the done at step t was a time-limit truncation
    # (graph_buffer.py:162,242-243); None == all ones == reference behavior
    bad_masks: Optional[Tensor] = None  # (T+1, B, N, 1)


def compute_returns(
    buffer: RolloutBuffer,
    next_value: Tensor,
    vn_state: Optional[ValueNormState],
    gamma: float = 0.99,
    gae_lambda: float = 0.95,
    use_gae: bool = True,
    use_proper_time_limits: bool = False,
) -> RolloutBuffer:
    """Returns over the rollout, all four reference branches
    (graph_buffer.py:285-366: {use_proper_time_limits} x {use_gae}).

    ``value_preds[-1]`` is overwritten with the bootstrap ``next_value`` as
    the reference does (:340).  With a value normalizer the recursion
    denormalizes the predictions (:344-352).  With proper time limits,
    ``bad_masks[t+1] = 0`` zeroes the accumulated GAE at a truncation
    (:312); in the non-GAE branch the return restarts from the value
    estimate there (:326-331).  The non-GAE branch seeds ``returns[-1]``
    with the raw bootstrap value, as the reference does.
    """
    value_preds = buffer.value_preds.clone()
    value_preds[-1] = next_value
    v = value_preds
    if vn_state is not None:
        v = vn_denormalize(vn_state, value_preds).to(buffer.rewards.dtype)
    bad = buffer.bad_masks if buffer.bad_masks is not None else torch.ones_like(buffer.masks)
    T = buffer.rewards.shape[0]
    rewards, masks = buffer.rewards, buffer.masks

    out = [None] * T
    if use_gae:
        gae = torch.zeros_like(rewards[0])
        for t in reversed(range(T)):
            delta = rewards[t] + gamma * v[t + 1] * masks[t + 1] - v[t]
            gae = delta + gamma * gae_lambda * masks[t + 1] * gae
            if use_proper_time_limits:
                gae = gae * bad[t + 1]
            out[t] = gae + v[t]
        last = buffer.returns[-1]
    else:
        ret = next_value
        for t in reversed(range(T)):
            ret = ret * gamma * masks[t + 1] + rewards[t]
            if use_proper_time_limits:
                ret = ret * bad[t + 1] + (1.0 - bad[t + 1]) * v[t]
            out[t] = ret
        last = next_value
    returns = torch.stack(out + [last], dim=0)
    return dataclasses.replace(buffer, value_preds=value_preds, returns=returns)
