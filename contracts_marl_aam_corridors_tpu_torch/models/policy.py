"""Policy wrapper: actor and critic parameters, optimizers and the action
API (port of ``models/policy.py``).

Counterpart of ``GR_MAPPOPolicy`` (onpolicy/algorithms/graph_MAPPOPolicy.py:
11-307): ``get_actions``, ``get_values``, ``act``, ``evaluate_actions``, two
Adam optimizers with eps 1e-5 and global-norm clipping (:71-77), and the
linear learning-rate decay (``lr_decay``:79).  As in the JAX package the
policy object holds the configuration and the parameters travel beside it:
``PolicyParams`` holds the actor and critic modules, ``TrainState`` their
optimizers.

Routing, as the JAX package's ``_transposed_routable`` (policy.py:237-247;
``ModelConfig.kernel_trunk``): where ``gnn_impl`` is not 'dense', the
actor gathers its own node, the critic pools globally and the heads are
averaged, every call (``get_actions``, ``evaluate_actions``, ``act`` and
``get_values``) runs both GNN trunks through the transposed formulation,
so on the card every trunk forward is the ``gnn_trunk_fwd`` kernel and
every trunk backward the ``gnn_trunk_bwd`` kernel.  (The JAX package runs
``act`` and ``get_values`` through its dense per-graph GNN there; the two
formulations compute the same function, held by the JAX package's own
tests at rtol 2e-4 / atol 2e-5.)  Otherwise every call runs the dense
per-graph modules (``models/nets.py gnn_dense_apply``), plain torch on the
card as on the CPU, as the JAX package's does.  The critic pools globally
and takes no agent ids (the JAX signature's ``share_agent_id``); the
actor's global pool ignores its ``agent_id``.  Inputs of any floating type
are cast to the parameters' float32.

``fuse_gnn_trunks`` (the JAX package's flag, policy.py:56, 81) acts where
the JAX package's does: in ``evaluate_actions`` on the dense route with the
actor's 'node' gather, both GNNs run as one pass over their stacked
parameters; the other calls and the kernel trunk run as without it.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from . import distributions as dist
from . import nets
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
    def __init__(
        self,
        cfg: ModelConfig,
        dims: PolicyDims,
        device=None,
        lr: float = 7e-4,
        critic_lr: float = 7e-4,
        opti_eps: float = 1e-5,
        max_grad_norm: float = 10.0,
        use_max_grad_norm: bool = True,
        fuse_gnn_trunks: bool = False,
    ):
        self.cfg = cfg
        self.dims = dims
        self.device = resolve_device(device)
        self.lr = lr
        self.critic_lr = critic_lr
        self.opti_eps = opti_eps
        self.max_grad_norm = max_grad_norm
        self.use_max_grad_norm = use_max_grad_norm
        self.fuse_gnn_trunks = fuse_gnn_trunks

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

    def init_opt_states(self, params: PolicyParams):
        """(actor, critic) Adam optimizers (graph_MAPPOPolicy.py:71-77), the
        counterpart of optax's ``inject_hyperparams(adam)``; the clipping
        that optax chains in front is ``learner.mappo.clip_by_global_norm``.
        No weight decay: the JAX package's optax Adam takes none."""
        adam = lambda m, lr: torch.optim.Adam(m.parameters(), lr=lr, eps=self.opti_eps)
        return adam(params.actor, self.lr), adam(params.critic, self.critic_lr)

    @staticmethod
    def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
        """Set an optimizer's learning rate (reference
        ``update_linear_schedule``: lr * (1 - episode/episodes))."""
        for group in opt.param_groups:
            group["lr"] = lr

    def lr_decay(self, ts, episode: int, episodes: int) -> None:
        """Per-episode linear decay of both optimizers (lr_decay:79)."""
        frac = episode / float(episodes)
        self.set_lr(ts.actor_opt, self.lr - self.lr * frac)
        self.set_lr(ts.critic_opt, self.critic_lr - self.critic_lr * frac)

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

    def _fused_routable(self) -> bool:
        """Whether ``evaluate_actions`` runs both GNNs as one pass
        (policy.py:387-409): ``fuse_gnn_trunks`` on the dense route with
        the actor's 'node' gather (the critic pools globally).  The kernel
        trunk keeps its two calls with the flag as without it."""
        return (self.fuse_gnn_trunks and not self.cfg.kernel_trunk
                and self.cfg.actor_graph_aggr == "node")

    def _fused_trunks(self, params: PolicyParams, obs, cent_obs, node_obs, adj, agent_id):
        """The JAX package's ``_fused_trunks`` (policy.py:169-208) on flat
        rows: both dense GNNs in one pass over their stacked parameters
        (``nets.gnn_dense_nodes_dual``), the actor's node gather and the
        critic's global pool, then each side's ``post_gnn``."""
        nodes_a, nodes_c = nets.gnn_dense_nodes_dual(
            params.actor.gnn_base, params.critic.gnn_base, node_obs, adj)
        nbd_a = nets.dense_aggregate(nodes_a, "node", agent_id)
        nbd_c = nets.dense_aggregate(nodes_c, self.cfg.global_aggr_type, None)
        return params.actor.post_gnn(obs, nbd_a), params.critic.post_gnn(cent_obs, nbd_c)

    def evaluate_actions(
        self,
        params: PolicyParams,
        cent_obs: Tensor,
        obs: Tensor,
        node_obs: Tensor,
        adj: Tensor,
        agent_id: Tensor,
        rnn_states_actor: Tensor,
        rnn_states_critic: Tensor,
        action: Tensor,
        masks: Tensor,
        available_actions: Tensor | None = None,
        active_masks: Tensor | None = None,
    ):
        """Training-time values, log-probs and entropy
        (graph_MAPPOPolicy.py:199-264), time-major as the JAX package's
        ``evaluate_actions(time_major=True)`` (policy.py:382-450).

        The leading axes are (L, B, ...); the RNN states are the (B, rN, H)
        states at each chunk's head.  Both GNN+MLP trunks run once over all
        L*B rows (with ``fuse_gnn_trunks`` on the dense route, both GNNs in
        one pass: ``_fused_trunks``), then a loop over the L steps advances
        both GRU heads with their masks.  The entropy is averaged over
        ``active_masks``.  Differentiable: on the card each trunk's backward
        is the ``gnn_trunk_bwd`` kernel.
        """
        L = obs.shape[0]
        flat = lambda x: x.reshape((L * x.shape[1],) + x.shape[2:])
        unflat = lambda x: x.reshape((L, -1) + x.shape[1:])
        node_obs, adj, masks = _f32(node_obs), _f32(adj), _f32(masks)
        available_actions = _f32(available_actions)
        obs, cent_obs = _f32(flat(obs)), _f32(flat(cent_obs))
        node_obs, adj = flat(node_obs), flat(adj)
        if self._fused_routable():
            feats_a, feats_c = self._fused_trunks(params, obs, cent_obs, node_obs, adj,
                                                  flat(agent_id))
        else:
            feats_a = params.actor.trunk(obs, node_obs, adj, flat(agent_id))
            feats_c = params.critic.trunk(cent_obs, node_obs, adj, None)
        feats_a, feats_c = unflat(feats_a), unflat(feats_c)
        h_a, h_c = _f32(rnn_states_actor), _f32(rnn_states_critic)
        logits, values = [], []
        for t in range(L):
            avail = None if available_actions is None else available_actions[t]
            lg, h_a = params.actor.head(feats_a[t], h_a, masks[t], avail)
            v, h_c = params.critic.head(feats_c[t], h_c, masks[t])
            logits.append(lg)
            values.append(v)
        logits, values = torch.stack(logits), torch.stack(values)
        action_log_probs = dist.log_probs(logits, action)
        ent = dist.entropy(logits)
        if active_masks is not None:
            am = _f32(active_masks).squeeze(-1)
            dist_entropy = (ent * am).sum() / am.sum()
        else:
            dist_entropy = ent.mean()
        return values, action_log_probs, dist_entropy

