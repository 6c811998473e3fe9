"""Policy wrapper: actor and critic parameters and the action API (port of
``models/policy.py``, inference half).

Counterpart of ``GR_MAPPOPolicy`` (onpolicy/algorithms/graph_MAPPOPolicy.py:
11-307): ``get_actions``, ``get_values`` and ``act``.  As in the JAX package
the policy object holds the configuration and the parameters travel beside
it: ``PolicyParams`` holds the actor and critic modules.

Routing: all three calls run both GNN trunks through the transposed
formulation, so on the card every trunk call is the ``gnn_trunk_fwd``
kernel.  (The JAX package runs ``act`` and ``get_values`` through its dense
per-graph GNN; the two formulations compute the same function, held by the
JAX package's own tests at rtol 2e-4 / atol 2e-5.)  Inputs of any floating
type are cast to the parameters' float32.  The optimizers, ``evaluate_actions``
and the learning-rate schedule come with training.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from . import distributions as dist
from .actor_critic import GRActor, GRCritic
from .config import ModelConfig

__all__ = ["GRMAPPOPolicy", "PolicyParams", "PolicyDims"]

Tensor = torch.Tensor


@dataclasses.dataclass
class PolicyParams:
    actor: GRActor
    critic: GRCritic


@dataclasses.dataclass(frozen=True)
class PolicyDims:
    obs_dim: int
    cent_obs_dim: int
    num_entities: int
    node_feat_dim: int
    num_actions: int


def _f32(x: Tensor | None) -> Tensor | None:
    return None if x is None else x.to(torch.float32)


class GRMAPPOPolicy:
    def __init__(self, cfg: ModelConfig, dims: PolicyDims, device=None):
        self.cfg = cfg
        self.dims = dims
        self.device = resolve_device(device)

    def init_params(self, seed: int) -> PolicyParams:
        """Fresh actor and critic, drawn on the CPU from ``seed`` (the same
        weights whatever the device) and moved to the policy's device."""
        gen = torch.Generator().manual_seed(seed)
        d, cfg = self.dims, self.cfg
        with torch.device("meta"):
            actor = GRActor(cfg, d.obs_dim, d.node_feat_dim, d.num_actions)
            critic = GRCritic(cfg, d.cent_obs_dim, d.node_feat_dim)
        actor = actor.to_empty(device="cpu")
        critic = critic.to_empty(device="cpu")
        actor.init_(gen)
        critic.init_(gen)
        return PolicyParams(actor=actor.to(self.device), critic=critic.to(self.device))

    @torch.no_grad()
    def get_actions(
        self,
        params: PolicyParams,
        gen: torch.Generator,
        cent_obs: Tensor,
        obs: Tensor,
        node_obs: Tensor,
        adj: Tensor,
        agent_id: Tensor,
        rnn_states_actor: Tensor,
        rnn_states_critic: Tensor,
        masks: Tensor,
        available_actions: Tensor | None = None,
        deterministic: bool = False,
    ):
        """Rollout-time joint actor and critic pass (graph_MAPPOPolicy.py:
        96-165).  The critic pools globally, so it takes no agent ids (the
        JAX signature's ``share_agent_id``)."""
        node_obs, adj, masks = _f32(node_obs), _f32(adj), _f32(masks)
        feats_a = params.actor.trunk(_f32(obs), node_obs, adj, agent_id)
        feats_c = params.critic.trunk(_f32(cent_obs), node_obs, adj, None)
        logits, rnn_states_actor = params.actor.head(
            feats_a, _f32(rnn_states_actor), masks, _f32(available_actions)
        )
        values, rnn_states_critic = params.critic.head(
            feats_c, _f32(rnn_states_critic), masks
        )
        actions = dist.mode(logits) if deterministic else dist.sample(gen, logits)
        action_log_probs = dist.log_probs(logits, actions)
        return values, actions, action_log_probs, rnn_states_actor, rnn_states_critic

    @torch.no_grad()
    def get_values(self, params: PolicyParams, cent_obs, node_obs, adj, rnn_states_critic,
                   masks) -> Tensor:
        values, _ = params.critic(
            _f32(cent_obs), _f32(node_obs), _f32(adj), None, _f32(rnn_states_critic),
            _f32(masks),
        )
        return values

    @torch.no_grad()
    def act(self, params: PolicyParams, gen: torch.Generator | None, obs, node_obs, adj,
            agent_id, rnn_states_actor, masks, available_actions=None,
            deterministic: bool = False):
        logits, rnn_states_actor = params.actor(
            _f32(obs), _f32(node_obs), _f32(adj), agent_id, _f32(rnn_states_actor),
            _f32(masks), _f32(available_actions),
        )
        actions = dist.mode(logits) if deterministic else dist.sample(gen, logits)
        return actions, rnn_states_actor
