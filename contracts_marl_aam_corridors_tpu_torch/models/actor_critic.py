"""Graph-recurrent actor and critic (reference ``GR_Actor``/``GR_Critic``,
onpolicy/algorithms/graph_actor_critic.py:32-397), port of
``models/actor_critic.py``.

Shapes (single step):
    obs         (B, obs_dim)          flattened threads*agents rows
    node_obs    (B, E, F)
    adj         (B, E, E)
    agent_id    (B, 1)
    rnn_states  (B, recurrent_N, H)
    masks       (B, 1)   0 => episode boundary, reset hidden state
    available_actions (B, A) or None

Each network splits into ``trunk`` (GNN + MLP, time-independent) and
``head`` (GRU + output, carries state), with ``post_gnn`` the trunk's tail.
"""
from __future__ import annotations

import torch
from torch import nn

from . import distributions as dist
from .config import ModelConfig
from .nets import GNNBase, MLPBase, RNNLayer, dense_init_

Tensor = torch.Tensor


class GRActor(nn.Module):
    """GNN (ego-node gather) ++ obs -> MLP -> GRU -> categorical logits."""

    def __init__(self, cfg: ModelConfig, obs_dim: int, node_feat_dim: int, num_actions: int):
        super().__init__()
        self.cfg = cfg
        self.gnn_base = GNNBase(cfg, node_feat_dim, "node")
        self.base = MLPBase(cfg, obs_dim + cfg.gnn_out_dim)
        if cfg.use_recurrent_policy:
            self.rnn = RNNLayer(cfg, cfg.hidden_size)
        self.action_out = nn.Linear(cfg.hidden_size, num_actions)

    def init_(self, gen: torch.Generator) -> None:
        self.gnn_base.init_(gen)
        self.base.init_(gen)
        if self.cfg.use_recurrent_policy:
            self.rnn.init_(gen)
        dense_init_(self.action_out.weight, self.cfg, self.cfg.gain, gen)
        nn.init.zeros_(self.action_out.bias)

    def trunk(self, obs, node_obs, adj, agent_id) -> Tensor:
        return self.post_gnn(obs, self.gnn_base(node_obs, adj, agent_id))

    def post_gnn(self, obs: Tensor, nbd: Tensor) -> Tensor:
        return self.base(torch.cat([obs, nbd], dim=-1))

    def head(self, features, rnn_states, masks, available_actions=None):
        x = features
        if self.cfg.use_recurrent_policy:
            x, rnn_states = self.rnn(x, rnn_states, masks)
        logits = dist.mask_logits(self.action_out(x), available_actions)
        return logits, rnn_states

    def forward(self, obs, node_obs, adj, agent_id, rnn_states, masks,
                available_actions=None):
        return self.head(self.trunk(obs, node_obs, adj, agent_id), rnn_states, masks,
                         available_actions)


class GRCritic(nn.Module):
    """GNN (global pool) [++ cent_obs] -> MLP -> GRU -> scalar value."""

    def __init__(self, cfg: ModelConfig, cent_obs_dim: int, node_feat_dim: int):
        super().__init__()
        self.cfg = cfg
        self.gnn_base = GNNBase(cfg, node_feat_dim, "global")
        in_dim = cfg.gnn_out_dim + (cent_obs_dim if cfg.use_cent_obs else 0)
        self.base = MLPBase(cfg, in_dim)
        if cfg.use_recurrent_policy:
            self.rnn = RNNLayer(cfg, cfg.hidden_size)
        self.v_out = nn.Linear(cfg.hidden_size, 1)

    def init_(self, gen: torch.Generator) -> None:
        self.gnn_base.init_(gen)
        self.base.init_(gen)
        if self.cfg.use_recurrent_policy:
            self.rnn.init_(gen)
        dense_init_(self.v_out.weight, self.cfg, 1.0, gen)
        nn.init.zeros_(self.v_out.bias)

    def trunk(self, cent_obs, node_obs, adj, agent_id) -> Tensor:
        return self.post_gnn(cent_obs, self.gnn_base(node_obs, adj, agent_id))

    def post_gnn(self, cent_obs: Tensor, nbd: Tensor) -> Tensor:
        if self.cfg.use_cent_obs:
            nbd = torch.cat([cent_obs, nbd], dim=-1)
        return self.base(nbd)

    def head(self, features, rnn_states, masks):
        x = features
        if self.cfg.use_recurrent_policy:
            x, rnn_states = self.rnn(x, rnn_states, masks)
        return self.v_out(x), rnn_states

    def forward(self, cent_obs, node_obs, adj, agent_id, rnn_states, masks):
        return self.head(self.trunk(cent_obs, node_obs, adj, agent_id), rnn_states, masks)
