"""Recurrent MAPPO trainer (reference ``GR_MAPPO``,
onpolicy/algorithms/graph_mappo.py:21-369), port of ``learner/mappo.py``.

The update runs eagerly: advantage normalization, recurrent chunking, then
``ppo_epoch`` x ``num_mini_batch`` minibatch updates, each one forward and
backward of both networks and one step of each Adam.  The reference's
recurrent_generator (graph_buffer.py:597-758) reorders (T, B, N, ...) ->
(B, N, T, ...) -> flat and slices contiguous ``data_chunk_length`` windows
with the GRU state captured at each chunk head; the windows tile the
flattened axis, so they may straddle two agents' sequences, as in the
reference.  The parameters, optimizer states and the value normalizer in a
``TrainState`` are updated in place (the JAX package returns new ones).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.policy import GRMAPPOPolicy, PolicyParams
from .buffer import RolloutBuffer
from .popart import PopArtState, popart_init, popart_update, rescale_v_out
from .valuenorm import ValueNormState, vn_denormalize, vn_init, vn_normalize, vn_update

Tensor = torch.Tensor

INFO_KEYS = ("value_loss", "policy_loss", "dist_entropy", "actor_grad_norm",
             "critic_grad_norm", "ratio")


@dataclasses.dataclass
class TrainState:
    """Policy parameters, the value normalizer (``ValueNormState``,
    ``PopArtState`` or None) and the two optimizers (None for a state that
    only rolls out)."""
    params: PolicyParams
    vn: Optional[ValueNormState | PopArtState]
    actor_opt: Optional[torch.optim.Optimizer] = None
    critic_opt: Optional[torch.optim.Optimizer] = None


def huber(e: Tensor, delta: float) -> Tensor:
    """Reference ``huber_loss`` (onpolicy/utils/util.py:24-27), bug for bug:
    the linear branch tests ``e > delta``, not ``|e| > delta``, so errors
    below ``-delta`` give zero loss and gradient."""
    a = (e.abs() <= delta).to(e.dtype)
    b = (e > delta).to(e.dtype)
    return a * e**2 / 2 + b * delta * (e.abs() - delta / 2)


def cal_value_loss(values, value_preds, returns, active_masks, vn, *, clip_param: float,
                   use_huber_loss: bool, huber_delta: float, use_clipped_value_loss: bool,
                   use_value_active_masks: bool) -> Tensor:
    """Reference ``GR_MAPPO.cal_value_loss`` (graph_mappo.py:70-119): value
    clip around the old predictions, normalized-return targets (``vn`` is the
    already-updated normalizer state or None), huber or mse, max of clipped
    and original, active-mask averaging."""
    v_clipped = value_preds + torch.clamp(values - value_preds, -clip_param, clip_param)
    tgt = vn_normalize(vn, returns) if vn is not None else returns
    e_clip, e_orig = tgt - v_clipped, tgt - values
    if use_huber_loss:
        vl_clip, vl_orig = huber(e_clip, huber_delta), huber(e_orig, huber_delta)
    else:
        vl_clip, vl_orig = 0.5 * e_clip**2, 0.5 * e_orig**2
    vl = torch.maximum(vl_orig, vl_clip) if use_clipped_value_loss else vl_orig
    if use_value_active_masks:
        return (vl * active_masks).sum() / active_masks.sum()
    return vl.mean()


def _masked_mean_std(x: Tensor, mask: Tensor):
    """Mean and std over active entries (graph_mappo.py:300-304)."""
    total = torch.clamp(mask.sum(), min=1.0)
    mean = (x * mask).sum() / total
    var = (((x - mean) ** 2) * mask).sum() / total
    return mean, torch.sqrt(var)


def _to_chunks(x: Tensor, L: int) -> Tensor:
    """(T, B, N, ...) -> (S, L, ...) with S = B*N*T // L: the
    recurrent_generator's transpose(1, 2, 0).reshape and window slicing."""
    T, B, N = x.shape[:3]
    flat = x.movedim(0, 2).reshape((B * N * T,) + x.shape[3:])
    S = (B * N * T) // L
    return flat[: S * L].reshape((S, L) + x.shape[3:])


ORDER = ("share_obs", "obs", "node_obs", "adj", "agent_id", "h_actor", "h_critic", "actions",
         "value_preds", "returns", "masks", "active_masks", "old_logp", "adv", "avail")
HEAD_KEYS = ("h_actor", "h_critic")


@dataclasses.dataclass(frozen=True)
class GRMAPPOTrainer:
    policy: GRMAPPOPolicy
    clip_param: float = 0.2
    ppo_epoch: int = 15
    num_mini_batch: int = 1
    data_chunk_length: int = 10
    value_loss_coef: float = 1.0
    entropy_coef: float = 0.01
    huber_delta: float = 10.0
    gamma: float = 0.99
    gae_lambda: float = 0.95
    use_clipped_value_loss: bool = True
    use_huber_loss: bool = True
    use_valuenorm: bool = True
    use_popart: bool = False
    use_value_active_masks: bool = True
    use_policy_active_masks: bool = True
    # return-computation branches (graph_buffer.py:285-366), read by the runner
    use_gae: bool = True
    use_proper_time_limits: bool = False

    def init_state(self, seed: int, dtype=torch.float32) -> TrainState:
        params = self.policy.init_params(seed)
        a_opt, c_opt = self.policy.init_opt_states(params)
        dev = self.policy.device
        if self.use_popart:
            vn = popart_init(dtype, dev)
        elif self.use_valuenorm:
            vn = vn_init(dtype, dev)
        else:
            vn = None
        return TrainState(params=params, vn=vn, actor_opt=a_opt, critic_opt=c_opt)

    # ------------------------------------------------------------------
    def loss(self, params: PolicyParams, vn, batch: dict):
        """The PPO loss of one time-major minibatch (graph_mappo.py:121-200)
        with ``vn`` the already-updated normalizer: ``(total, (policy_loss,
        value_loss, entropy, mean ratio))``."""
        b = batch
        values, logp, entropy = self.policy.evaluate_actions(
            params, b["share_obs"], b["obs"], b["node_obs"], b["adj"], b["agent_id"],
            b["h_actor"], b["h_critic"], b["actions"], b["masks"], b["avail"],
            b["active_masks"],
        )
        ratio = torch.exp(logp - b["old_logp"])
        adv = b["adv"]
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1.0 - self.clip_param, 1.0 + self.clip_param) * adv
        obj = torch.minimum(surr1, surr2).sum(dim=-1, keepdim=True)
        am = b["active_masks"]
        policy_loss = (-(obj * am).sum() / am.sum() if self.use_policy_active_masks
                       else -obj.mean())
        value_loss = cal_value_loss(
            values, b["value_preds"], b["returns"], am, vn,
            clip_param=self.clip_param, use_huber_loss=self.use_huber_loss,
            huber_delta=self.huber_delta, use_clipped_value_loss=self.use_clipped_value_loss,
            use_value_active_masks=self.use_value_active_masks,
        )
        total = policy_loss - entropy * self.entropy_coef + value_loss * self.value_loss_coef
        return total, (policy_loss, value_loss, entropy, ratio.mean())

    def _minibatch_update(self, ts: TrainState, batch: dict) -> dict:
        """One ppo_update (graph_mappo.py:121-278), in place on ``ts``."""
        # the normalizer updates from the minibatch's returns BEFORE the loss
        # normalizes them (graph_mappo.py:93-99)
        popart = None
        if ts.vn is None:
            vn = None
        elif self.use_popart:
            vn, scale, shift = popart_update(ts.vn, batch["returns"].reshape(-1, 1))
            popart = (scale, shift)
        else:
            vn = vn_update(ts.vn, batch["returns"].reshape(-1, 1))

        actor, critic = ts.params.actor, ts.params.critic
        ts.actor_opt.zero_grad(set_to_none=True)
        ts.critic_opt.zero_grad(set_to_none=True)
        total, (policy_loss, value_loss, entropy, ratio) = self.loss(ts.params, vn, batch)
        total.backward()
        grads = {}
        for side, module in (("actor", actor), ("critic", critic)):
            for p in module.parameters():
                if p.grad is None:  # as optax, an unused weight gets a zero gradient
                    p.grad = torch.zeros_like(p)
            grads[side] = [p.grad for p in module.parameters()]
        actor_gn = optax_global_norm(grads["actor"])
        critic_gn = optax_global_norm(grads["critic"])
        if self.policy.use_max_grad_norm:
            clip_by_global_norm(grads["actor"], self.policy.max_grad_norm)
            clip_by_global_norm(grads["critic"], self.policy.max_grad_norm)
        if popart is not None:
            # the forward and backward used the old v_out; rescale it, then
            # apply the gradient step (graph_mappo.py:202-210)
            rescale_v_out(critic.v_out, *popart)
        ts.actor_opt.step()
        ts.critic_opt.step()
        ts.vn = vn
        return {
            "value_loss": value_loss.detach(), "policy_loss": policy_loss.detach(),
            "dist_entropy": entropy.detach(), "actor_grad_norm": actor_gn,
            "critic_grad_norm": critic_gn, "ratio": ratio.detach(),
        }

    # ------------------------------------------------------------------
    def chunks(self, ts: TrainState, buffer: RolloutBuffer) -> dict:
        """Normalized advantages and the (S, L, ...) chunk-major tensors of a
        rollout (graph_mappo.py ``train``:280-304, recurrent_generator); the
        RNN states are taken at each chunk's head."""
        L = self.data_chunk_length
        T, B, N = buffer.rewards.shape[:3]
        vp = buffer.value_preds[:-1]
        if ts.vn is not None:
            vp = vn_denormalize(ts.vn, vp)
        advantages = buffer.returns[:-1] - vp
        mean, std = _masked_mean_std(advantages, buffer.active_masks[:-1])
        advantages = (advantages - mean) / (std + 1e-5)
        # adj is stored per env: one copy per agent's graph
        adj = buffer.adj[:-1, :, None].expand((T, B, N) + buffer.adj.shape[2:])
        return dict(
            share_obs=_to_chunks(buffer.share_obs[:-1], L),
            obs=_to_chunks(buffer.obs[:-1], L),
            node_obs=_to_chunks(buffer.node_obs[:-1], L),
            adj=_to_chunks(adj, L),
            agent_id=_to_chunks(buffer.agent_id[:-1], L),
            h_actor=_to_chunks(buffer.rnn_states[:-1], L)[:, 0],
            h_critic=_to_chunks(buffer.rnn_states_critic[:-1], L)[:, 0],
            actions=_to_chunks(buffer.actions, L),
            value_preds=_to_chunks(buffer.value_preds[:-1], L),
            returns=_to_chunks(buffer.returns[:-1], L),
            masks=_to_chunks(buffer.masks[:-1], L),
            active_masks=_to_chunks(buffer.active_masks[:-1], L),
            old_logp=_to_chunks(buffer.action_log_probs, L),
            adv=_to_chunks(advantages, L),
            avail=_to_chunks(buffer.available_actions[:-1], L),
        )

    @staticmethod
    def _time_major(chunks: dict, idx: Tensor | None = None) -> dict:
        """Select chunks (all, or ``idx``) and put time first: (L, mb, ...);
        the head RNN states stay (mb, rN, H)."""
        out = {}
        for k in ORDER:
            v = chunks[k] if idx is None else chunks[k][idx]
            out[k] = v if k in HEAD_KEYS else v.transpose(0, 1).contiguous()
        return out

    def train(self, ts: TrainState, buffer: RolloutBuffer,
              gen: torch.Generator | None = None) -> tuple[TrainState, dict]:
        """The full update from a rollout (graph_mappo.py ``train``:280-369),
        in place on ``ts``; returns it and the mean of each loss and norm
        over all minibatch updates (0-d tensors).  ``gen`` draws the
        per-epoch chunk permutation when ``num_mini_batch > 1``."""
        chunks = self.chunks(ts, buffer)
        infos = []
        if self.num_mini_batch == 1:
            # one minibatch is the whole batch: shuffling cannot change it
            batch = self._time_major(chunks)
            for _ in range(self.ppo_epoch):
                infos.append(self._minibatch_update(ts, batch))
        else:
            if gen is None:
                raise ValueError("train: num_mini_batch > 1 needs a generator")
            S = chunks["obs"].shape[0]
            mb = S // self.num_mini_batch
            for _ in range(self.ppo_epoch):
                perm = torch.randperm(S, generator=gen, device=gen.device)
                perm = perm[: mb * self.num_mini_batch].reshape(self.num_mini_batch, mb)
                for idx in perm.to(chunks["obs"].device):
                    infos.append(self._minibatch_update(ts, self._time_major(chunks, idx)))
        train_info = {k: torch.stack([i[k] for i in infos]).mean() for k in INFO_KEYS}
        return ts, train_info


def optax_global_norm(tensors) -> Tensor:
    """sqrt of the sum of squares over all tensors (optax ``global_norm``,
    learner/mappo.py:311)."""
    return torch.sqrt(sum((t.to(torch.float32) ** 2).sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> Tensor:
    """optax ``clip_by_global_norm`` in place: where the global norm is not
    below ``max_norm`` every gradient becomes ``g / norm * max_norm``.  (Not
    ``torch.nn.utils.clip_grad_norm_``, which scales by
    ``max_norm / (norm + 1e-6)``.)  The norm is taken in the gradients' own
    type, as optax takes it; returns it."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    clipped = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clipped, g / norm.to(g.dtype) * max_norm, g))
    return norm
