"""Rollout and evaluation runner (port of ``learner/runner.py``: collect and
eval; the training episode comes with the PPO update).

Counterpart of the reference's ``GMPERunner`` collect / insert / compute
pipeline (onpolicy/runner/shared/graph_mpe_runner.py:40-516).  All envs and
the policy advance together on one device; the Python loop over time steps
replaces the JAX package's ``lax.scan``.

Semantics preserved:
- done agents are restricted to the center "stop" action via
  available_actions (collect_with_mask:277-283, index n//2);
- rnn states zeroed for done agents; masks[t+1]=0 at dones (insert:386-400);
- active_masks 0 for done agents but reset to 1 for all-done envs whose
  auto-reset started a fresh episode (insert:401-407);
- share_obs = concat of all agents' obs, repeated per agent (insert:410-422);
- bootstrap value from the post-rollout state (compute:430-443);
- ``available_actions[t]`` stores the mask used to sample ``actions[t]``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import resolve_device
from ..envs import env as env_mod
from ..envs.actions import stop_action_index
from ..envs.types import EnvParams, EnvState
from ..models.policy import GRMAPPOPolicy
from .buffer import RolloutBuffer, compute_returns
from .mappo import TrainState

Tensor = torch.Tensor


@dataclasses.dataclass
class RolloutCarry:
    env_state: EnvState
    obs: Tensor  # (B, N, obs)
    node_obs: Tensor  # (B, N, E, F)
    adj: Tensor  # (B, E, E)
    agent_id: Tensor  # (B, N, 1)
    rnn_actor: Tensor  # (B, N, rN, H)
    rnn_critic: Tensor  # (B, N, rN, H)
    masks: Tensor  # (B, N, 1)
    active_masks: Tensor  # (B, N, 1)
    bad_masks: Tensor  # (B, N, 1): 0 where the last done was a time-limit truncation
    prev_done: Tensor  # (B, N) bool, drives stop-action masking
    gen: torch.Generator  # env and action-sampling draws


@dataclasses.dataclass(frozen=True)
class Runner:
    env_params: EnvParams
    policy: GRMAPPOPolicy
    n_rollout_threads: int
    episode_length: int
    dtype: torch.dtype = torch.float32
    # return computation (the JAX package reads these from its trainer)
    gamma: float = 0.99
    gae_lambda: float = 0.95
    use_gae: bool = True
    use_proper_time_limits: bool = False
    device: Optional[torch.device] = None

    def __post_init__(self):
        dev = resolve_device(self.device)
        if dev != self.policy.device:
            raise ValueError(f"runner on {dev} but policy on {self.policy.device}")
        object.__setattr__(self, "device", dev)

    # ------------------------------------------------------------- helpers
    def _share(self, obs: Tensor) -> Tensor:
        """Centralized critic input: all agents' obs, repeated per agent."""
        B, N = obs.shape[:2]
        return obs.reshape(B, 1, -1).expand(B, N, -1)

    def _stop_avail(self, prev_done: Tensor) -> Tensor:
        """Done agents may only pick the center 'stop' action
        (collect_with_mask, graph_mpe_runner.py:277-283)."""
        A = self.policy.dims.num_actions
        stop = torch.zeros(A, dtype=self.dtype, device=self.device)
        stop[stop_action_index(A)] = 1.0
        return torch.where(prev_done[..., None], stop, torch.ones_like(stop))

    def _flat(self, x: Tensor) -> Tensor:
        return x.reshape((-1,) + x.shape[2:])

    def _adj_rep(self, adj: Tensor) -> Tensor:
        """The env's adjacency repeated for each agent's graph."""
        B, N, E = adj.shape[0], self.env_params.num_agents, adj.shape[-1]
        return adj[:, None].expand(B, N, E, E)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def init_carry(self, seed: int) -> RolloutCarry:
        B, N = self.n_rollout_threads, self.env_params.num_agents
        rN, H = self.policy.cfg.recurrent_n, self.policy.cfg.hidden_size
        gen = self._generator(seed)
        state, ts = env_mod.reset(self.env_params, B, gen, self.device, self.dtype)
        ones = torch.ones((B, N, 1), dtype=self.dtype, device=self.device)
        zeros_h = torch.zeros((B, N, rN, H), dtype=self.dtype, device=self.device)
        return RolloutCarry(
            env_state=state,
            obs=ts.obs,
            node_obs=ts.node_obs,
            adj=ts.adj,
            agent_id=ts.agent_id,
            rnn_actor=zeros_h,
            rnn_critic=zeros_h.clone(),
            masks=ones,
            active_masks=ones.clone(),
            bad_masks=ones.clone(),
            prev_done=torch.zeros((B, N), dtype=torch.bool, device=self.device),
            gen=gen,
        )

    # ------------------------------------------------------------- rollout
    def _rollout_step(self, ts: TrainState, carry: RolloutCarry):
        B, N = self.n_rollout_threads, self.env_params.num_agents
        flat = self._flat
        unflat = lambda x: x.reshape((B, N) + x.shape[1:])

        avail = self._stop_avail(carry.prev_done)
        share_obs = self._share(carry.obs)
        values, actions, logp, h_a, h_c = self.policy.get_actions(
            ts.params, carry.gen,
            flat(share_obs), flat(carry.obs), flat(carry.node_obs),
            flat(self._adj_rep(carry.adj)), flat(carry.agent_id), flat(carry.rnn_actor),
            flat(carry.rnn_critic), flat(carry.masks), flat(avail),
        )
        actions_bn = unflat(actions)

        env_state, step_ts = env_mod.step(
            self.env_params, carry.env_state, actions_bn[..., 0], carry.gen
        )
        dones = step_ts.done  # (B, N) terminal dones (pre auto-reset)
        dones_env = dones.all(dim=1)

        done_f = dones[..., None].to(self.dtype)
        masks = 1.0 - done_f
        active = torch.where(dones_env[:, None, None], torch.ones_like(masks), 1.0 - done_f)
        bad = 1.0 - step_ts.truncated[..., None].to(self.dtype)
        keep_h = (1.0 - done_f)[..., None]
        h_a = unflat(h_a).to(self.dtype) * keep_h
        h_c = unflat(h_c).to(self.dtype) * keep_h

        out = dict(
            share_obs=share_obs,
            obs=carry.obs,
            node_obs=carry.node_obs,
            adj=carry.adj,
            agent_id=carry.agent_id,
            rnn_states=carry.rnn_actor,
            rnn_states_critic=carry.rnn_critic,
            actions=actions_bn.to(self.dtype),
            action_log_probs=unflat(logp).to(self.dtype),
            value_preds=unflat(values).to(self.dtype),
            rewards=step_ts.reward[..., None],
            masks=carry.masks,
            active_masks=carry.active_masks,
            bad_masks=carry.bad_masks,
            available_actions=avail,
            info=step_ts.info,
        )
        new_carry = RolloutCarry(
            env_state=env_state,
            obs=step_ts.obs,
            node_obs=step_ts.node_obs,
            adj=step_ts.adj,
            agent_id=carry.agent_id,
            rnn_actor=h_a,
            rnn_critic=h_c,
            masks=masks,
            active_masks=active,
            bad_masks=bad,
            prev_done=dones,
            gen=carry.gen,
        )
        return new_carry, out

    def collect(self, ts: TrainState, carry: RolloutCarry):
        """One episode window: T steps, the (T+1) buffer, returns.

        Returns ``(carry, buffer, infos)`` with ``infos`` the env info dict
        stacked over the T steps."""
        T = self.episode_length
        B, N = self.n_rollout_threads, self.env_params.num_agents
        outs = []
        for _ in range(T):
            carry, out = self._rollout_step(ts, carry)
            outs.append(out)
        seq = lambda k: torch.stack([o[k] for o in outs])
        close = lambda k, last: torch.cat([seq(k), last[None]])

        share_last = self._share(carry.obs)
        avail_last = self._stop_avail(carry.prev_done)
        zeros = torch.zeros((B, N, 1), dtype=self.dtype, device=self.device)
        buffer = RolloutBuffer(
            share_obs=close("share_obs", share_last),
            obs=close("obs", carry.obs),
            node_obs=close("node_obs", carry.node_obs),
            adj=close("adj", carry.adj),
            agent_id=close("agent_id", carry.agent_id),
            rnn_states=close("rnn_states", carry.rnn_actor),
            rnn_states_critic=close("rnn_states_critic", carry.rnn_critic),
            actions=seq("actions"),
            action_log_probs=seq("action_log_probs"),
            value_preds=close("value_preds", zeros),
            returns=torch.zeros((T + 1, B, N, 1), dtype=self.dtype, device=self.device),
            rewards=seq("rewards"),
            masks=close("masks", carry.masks),
            active_masks=close("active_masks", carry.active_masks),
            available_actions=close("available_actions", avail_last),
            bad_masks=close("bad_masks", carry.bad_masks),
        )

        # bootstrap value (compute, graph_mpe_runner.py:430-443)
        flat = self._flat
        next_values = self.policy.get_values(
            ts.params, flat(share_last), flat(carry.node_obs), flat(self._adj_rep(carry.adj)),
            flat(carry.rnn_critic), flat(carry.masks),
        ).reshape(B, N, 1).to(self.dtype)
        buffer = compute_returns(
            buffer, next_values, ts.vn, self.gamma, self.gae_lambda,
            use_gae=self.use_gae, use_proper_time_limits=self.use_proper_time_limits,
        )
        infos = {k: torch.stack([o["info"][k] for o in outs]) for k in outs[0]["info"]}
        return carry, buffer, infos

    # ------------------------------------------------------------- eval
    def eval_episode(self, ts: TrainState, seed: int, n_eval: int) -> dict:
        """Deterministic evaluation (reference ``GMPERunner.eval``,
        graph_mpe_runner.py:445-516): fresh envs, ``policy.act`` with
        deterministic=True, one episode window.

        Reports the reference's eval reward plus success (dist_to_goal below
        the goal threshold, base_runner.py:499-505), gate success (frozen
        before the time limit) and collision/conformance metrics.  Per-env
        metrics are latched at the step the env first finishes (all agents
        done, pre-auto-reset).  Returns Python floats.
        """
        B, N = n_eval, self.env_params.num_agents
        rN, H = self.policy.cfg.recurrent_n, self.policy.cfg.hidden_size
        gen = self._generator(seed)
        state, ts0 = env_mod.reset(self.env_params, B, gen, self.device, self.dtype)
        obs, node_obs, adj, agent_id = ts0.obs, ts0.node_obs, ts0.adj, ts0.agent_id
        h = torch.zeros((B, N, rN, H), dtype=self.dtype, device=self.device)
        masks = torch.ones((B, N, 1), dtype=self.dtype, device=self.device)
        prev_done = torch.zeros((B, N), dtype=torch.bool, device=self.device)
        latched = torch.zeros((B,), dtype=torch.bool, device=self.device)
        reached = torch.zeros((B, N), dtype=torch.bool, device=self.device)
        ep_rew = torch.zeros((B, N), dtype=self.dtype, device=self.device)
        info = None
        flat = self._flat
        unflat = lambda x: x.reshape((B, N) + x.shape[1:])

        for t in range(self.env_params.episode_length):
            avail = self._stop_avail(prev_done)
            actions, h_new = self.policy.act(
                ts.params, None, flat(obs), flat(node_obs), flat(self._adj_rep(adj)),
                flat(agent_id),
                flat(h), flat(masks), flat(avail), deterministic=True,
            )
            state, st = env_mod.step(self.env_params, state, unflat(actions)[..., 0], gen)
            dones = st.done
            done_f = dones[..., None].to(self.dtype)
            if info is None:
                info = st.info
            else:  # keep each env's info from the step it first finished
                info = {
                    k: torch.where(latched.reshape((B,) + (1,) * (v.ndim - 1)), v, st.info[k])
                    for k, v in info.items()
                }
            # gate success: done before the time-limit step, first episode only
            before_limit = t < self.env_params.episode_length - 1
            if before_limit:
                reached = reached | (dones & ~latched[:, None])
            obs, node_obs, adj = st.obs, st.node_obs, st.adj
            h = unflat(h_new).to(self.dtype) * (1.0 - done_f[..., None])
            masks = 1.0 - done_f
            prev_done = dones
            latched = latched | dones.all(dim=1)
            ep_rew = ep_rew + st.reward

        thresh = self.env_params.cfg.goal_threshold
        success = (info["Dist_to_goal_precise"] < thresh).to(self.dtype)
        gate = reached.to(self.dtype)
        out = {
            "eval_average_episode_rewards": ep_rew.mean(),
            "eval_success_rate": success.mean(),
            "eval_all_success_rate": (success > 0.5).all(dim=1).to(self.dtype).mean(),
            "eval_num_agent_collisions": info["Num_agent_collisions"].mean(),
            "eval_conformance": info["Conformance"].mean(),
            "eval_time_mean": info["Time_mean"].mean(),
            "eval_dist_to_goal": info["Dist_to_goal"].mean(),
            "eval_phase_reached": info["Phase_reached"].mean(),
            "eval_gate_success_rate": gate.mean(),
            "eval_all_gate_success_rate": (gate > 0.5).all(dim=1).to(self.dtype).mean(),
        }
        values = torch.stack(list(out.values())).tolist()
        return dict(zip(out, values))
