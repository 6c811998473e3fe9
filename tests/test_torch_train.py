"""The torch port's PPO update against the JAX package's, on the CPU.

Small sizes throughout: 4 envs, T = 8, ``data_chunk_length`` 4, ``ppo_epoch``
2, one minibatch, tanh activations (relu's subgradients flip at zero under a
different summation order).  Inputs come from numpy seeds; JAX parameters,
optimizer states and value normalizers come across through
``models/convert.py``.  The JAX side runs its dense per-graph GNN, which
computes the same function as the port's transposed trunk (held by the JAX
package's own tests at rtol 2e-4 / atol 2e-5) and compiles in seconds.
Each test states its tolerance.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from contracts_marl_aam_corridors_tpu.config.physics import vehicle_config as jvehicle
from contracts_marl_aam_corridors_tpu.envs.types import EnvParams as JEnvParams
from contracts_marl_aam_corridors_tpu.learner import mappo as jmappo
from contracts_marl_aam_corridors_tpu.learner import popart as jpopart
from contracts_marl_aam_corridors_tpu.learner import valuenorm as jvn
from contracts_marl_aam_corridors_tpu.learner.runner import Runner as JRunner
from contracts_marl_aam_corridors_tpu.models import GRMAPPOPolicy as JPolicy
from contracts_marl_aam_corridors_tpu.models import ModelConfig as JModelConfig
from contracts_marl_aam_corridors_tpu.models import PolicyDims as JDims

from contracts_marl_aam_corridors_tpu_torch.config.physics import vehicle_config
from contracts_marl_aam_corridors_tpu_torch.envs.types import EnvParams, env_state_from_numpy
from contracts_marl_aam_corridors_tpu_torch.learner import (
    GRMAPPOTrainer,
    RolloutBuffer,
    RolloutCarry,
    Runner,
    TrainState,
    mappo,
    popart,
    valuenorm,
)
from contracts_marl_aam_corridors_tpu_torch.models import (
    GRMAPPOPolicy,
    ModelConfig,
    PolicyDims,
    distributions,
    policy_params_from_flax,
)
from contracts_marl_aam_corridors_tpu_torch.models.convert import (
    load_adam_from_optax,
    state_dict_from_flax,
    value_norm_from_numpy,
)

torch.set_num_threads(1)

NET_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
# the JAX package's gradient bar (tests/test_models.py:611-613), per leaf
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
B, T, L, EPOCHS = 4, 8, 4, 2
CPU = torch.device("cpu")
F64 = dict(rtol=1e-12, atol=1e-12)


def assert_leaf_close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL, what=""):
    """|got - want| <= rtol * max|want| + atol over the leaf."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bar = rtol * np.abs(want).max() + atol
    assert np.abs(got - want).max() <= bar, (what, np.abs(got - want).max(), bar)


def dims_of(ep):
    return (ep.obs_dim, ep.obs_dim * ep.num_agents, ep.num_entities, ep.node_feat_dim,
            ep.num_actions)


TANH = dict(use_relu=False, embed_use_relu=False, gnn_use_relu=False)


# ---------------------------------------------------------------- JAX runs
@functools.lru_cache(maxsize=None)
def jax_runs():
    """Two JAX train episodes (collect + train, each jitted once): the first
    gives a TrainState that has taken Adam steps and moved its normalizer,
    the second the reference the port is held to."""
    jep = JEnvParams(cfg=jvehicle("air_taxi"), episode_length=25)
    jcfg = JModelConfig(max_edge_dist=jep.cfg.coordination_range, gnn_impl="dense", **TANH)
    jpol = JPolicy(jcfg, JDims(*dims_of(jep)))
    jtr = jmappo.GRMAPPOTrainer(jpol, ppo_epoch=EPOCHS, num_mini_batch=1, data_chunk_length=L)
    jrunner = JRunner(env_params=jep, policy=jpol, trainer=jtr, n_rollout_threads=B,
                      episode_length=T)
    collect, train = jax.jit(jrunner.collect), jax.jit(jtr.train)
    ts0 = jax.jit(jtr.init_state)(jax.random.PRNGKey(0))
    carry0 = jax.jit(jrunner.init_carry)(jax.random.PRNGKey(4))
    carry1, buf1, _ = collect(ts0, carry0)
    ts1, _ = train(ts0, buf1, jax.random.PRNGKey(1))
    carry2, buf2, info2 = collect(ts1, carry1)
    ts2, tinfo2 = train(ts1, buf2, jax.random.PRNGKey(2))
    to_np = lambda x: jax.tree.map(np.asarray, x)
    return dict(ts1=to_np(ts1), carry1=carry1, buf2=to_np(buf2), info2=to_np(info2),
                ts2=to_np(ts2), tinfo2=to_np(tinfo2))


def port_trainer(ep_len=25):
    ep = EnvParams(cfg=vehicle_config("air_taxi"), episode_length=ep_len)
    pol = GRMAPPOPolicy(ModelConfig(max_edge_dist=ep.cfg.coordination_range, **TANH),
                        PolicyDims(*dims_of(ep)), device="cpu")
    return ep, GRMAPPOTrainer(pol, ppo_epoch=EPOCHS, num_mini_batch=1, data_chunk_length=L)


def port_state(trainer, jts) -> TrainState:
    """The port's TrainState from a JAX one: weights, both Adam states and
    the value normalizer."""
    ts = trainer.init_state(0)
    sd_a, sd_c = policy_params_from_flax(jts.params.actor, jts.params.critic)
    ts.params.actor.load_state_dict(sd_a)
    ts.params.critic.load_state_dict(sd_c)
    load_adam_from_optax(ts.actor_opt, ts.params.actor, jts.actor_opt)
    load_adam_from_optax(ts.critic_opt, ts.params.critic, jts.critic_opt)
    ts.vn = value_norm_from_numpy(jts.vn, CPU)
    return ts


def port_buffer(jbuf) -> RolloutBuffer:
    t = lambda x: None if x is None else torch.tensor(np.asarray(x))
    fields = {f.name: t(getattr(jbuf, f.name)) for f in dataclasses.fields(RolloutBuffer)}
    fields["agent_id"] = fields["agent_id"].to(torch.long)
    return RolloutBuffer(**fields)


def assert_state_matches(ts: TrainState, jts):
    """New weights at rtol 1e-4 / atol 1e-5; Adam moments per leaf at 1e-3
    of the leaf's largest value (they hold the gradients, which two float32
    backward passes give at the 1e-4 gradient bar, and their squares) and
    equal step counts; the normalizer at rtol 1e-6 (float32 EMAs of the
    same returns)."""
    for side in ("actor", "critic"):
        module = getattr(ts.params, side)
        want = state_dict_from_flax(getattr(jts.params, side))
        for n, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), err_msg=n,
                                       **PARAM_TOL)
        adam = jax.tree.leaves(getattr(jts, f"{side}_opt"),
                               is_leaf=lambda x: hasattr(x, "mu"))
        adam = next(a for a in adam if hasattr(a, "mu"))
        mu, nu = state_dict_from_flax(adam.mu), state_dict_from_flax(adam.nu)
        opt = getattr(ts, f"{side}_opt")
        for n, p in module.named_parameters():
            st = opt.state[p]
            assert int(st["step"]) == int(adam.count)
            assert_leaf_close(st["exp_avg"].numpy(), mu[n].numpy(), 1e-3, 1e-9, f"mu {n}")
            assert_leaf_close(st["exp_avg_sq"].numpy(), nu[n].numpy(), 1e-3, 1e-12, f"nu {n}")
    for k in ("running_mean", "running_mean_sq", "debiasing_term"):
        np.testing.assert_allclose(getattr(ts.vn, k).numpy(), getattr(jts.vn, k), rtol=1e-6,
                                   err_msg=k)


def assert_info_matches(info, jinfo):
    """Losses and norms at rtol 1e-4; atol 1e-6 because the first epoch's
    policy loss is minus the mean normalized advantage, zero up to
    rounding."""
    assert set(mappo.INFO_KEYS) <= set(info) and set(info) <= set(jinfo)
    for k, v in info.items():
        np.testing.assert_allclose(float(v), float(jinfo[k]), rtol=1e-4, atol=1e-6, err_msg=k)


def test_train_matches_jax_from_converted_state():
    """One ``GRMAPPOTrainer.train`` from a JAX buffer and a JAX TrainState
    that has already taken Adam steps (both converted) against the JAX
    trainer's: new weights, Adam moments, normalizer state and train_info
    (tolerances in ``assert_state_matches`` and ``assert_info_matches``).
    With one minibatch the normalizer is updated before each epoch's loss,
    ``ppo_epoch`` times per train."""
    runs = jax_runs()
    assert np.all(runs["buf2"].masks == 1.0)
    _, trainer = port_trainer()
    ts = port_state(trainer, runs["ts1"])
    deb0 = ts.vn.debiasing_term.clone()
    ts, info = trainer.train(ts, port_buffer(runs["buf2"]))
    assert_state_matches(ts, runs["ts2"])
    assert_info_matches(info, runs["tinfo2"])
    beta = ts.vn.beta
    torch.testing.assert_close(ts.vn.debiasing_term,
                               deb0 * beta**EPOCHS + (1 - beta**EPOCHS), rtol=1e-6, atol=0)


def carry_from_jax(jc) -> RolloutCarry:
    fields = {}
    for f in dataclasses.fields(jc.env_state):
        v = getattr(jc.env_state, f.name)
        if v is None:
            continue
        fields[f.name] = (
            {g.name: np.asarray(getattr(v, g.name)) for g in dataclasses.fields(v)}
            if f.name == "tube" else np.asarray(v))
    t = lambda x: torch.tensor(np.asarray(x))
    return RolloutCarry(
        env_state=env_state_from_numpy(fields, CPU, torch.float32),
        obs=t(jc.obs), node_obs=t(jc.node_obs), adj=t(jc.adj),
        agent_id=t(jc.agent_id).to(torch.long),
        rnn_actor=t(jc.rnn_actor), rnn_critic=t(jc.rnn_critic), masks=t(jc.masks),
        active_masks=t(jc.active_masks), bad_masks=t(jc.bad_masks),
        prev_done=t(jc.prev_done), gen=torch.Generator().manual_seed(0),
    )


def test_train_episode_matches_jax(monkeypatch):
    """``Runner.train_episode`` end to end (collect, then train) against the
    JAX runner's collect and train from the same TrainState and carry, with
    the JAX run's actions replayed (sampling draws differ between the
    frameworks).  Weights, Adam moments and normalizer as in
    ``assert_state_matches``; train_info and ``average_episode_rewards`` at
    rtol 1e-4; the env infos at rtol 1e-5 / atol 1e-6 (float32 envs)."""
    runs = jax_runs()
    ep, trainer = port_trainer()
    ts = port_state(trainer, runs["ts1"])
    runner = Runner(env_params=ep, policy=trainer.policy, trainer=trainer,
                    n_rollout_threads=B, episode_length=T, device="cpu")
    jactions = runs["buf2"].actions.astype(np.int64)
    step = iter(range(T))
    monkeypatch.setattr(distributions, "sample",
                        lambda gen, logits: torch.tensor(jactions[next(step)]).reshape(-1, 1))
    ts, _, info, env_info = runner.train_episode(ts, carry_from_jax(runs["carry1"]))
    assert_state_matches(ts, runs["ts2"])
    jinfo = dict(runs["tinfo2"])
    jinfo["average_episode_rewards"] = runs["buf2"].rewards.mean() * T
    assert_info_matches(info, jinfo)
    np.testing.assert_allclose(info["average_episode_rewards"].item(),
                               jinfo["average_episode_rewards"], rtol=1e-4)
    assert set(env_info) == set(runs["info2"])
    for k, v in env_info.items():
        np.testing.assert_allclose(v.item(), runs["info2"][k][-1].mean(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------- policy
def test_evaluate_actions_and_loss_grads_match_jax():
    """Time-major ``evaluate_actions`` (L = 4 steps, 8 chunks, masks with
    episode starts, some actions unavailable) against the JAX package's:
    values, log-probs and entropy at rtol 2e-4 / atol 2e-5; then the
    gradients of the PPO loss (``GRMAPPOTrainer.loss`` against the JAX
    trainer's loss written from the same functions) per leaf at the JAX
    gradient bar."""
    ep = EnvParams(cfg=vehicle_config("air_taxi"))
    d = dims_of(ep)
    N, E, F, A, R = ep.num_agents, ep.num_entities, ep.node_feat_dim, ep.num_actions, 8
    rng = np.random.RandomState(3)
    f32 = lambda x: np.asarray(x, np.float32)
    node = f32(rng.randn(L, R, E, F))
    node[..., -1] = rng.randint(0, 3, (L, R, E))
    a = rng.rand(L, R, E, E) * 2 * ep.cfg.coordination_range
    adj = f32((a + a.transpose(0, 1, 3, 2)) / 2)
    adj[:, :, np.arange(E), np.arange(E)] = 0.0
    avail = f32(rng.rand(L, R, A) > 0.2)
    avail[..., A // 2] = 1.0
    logits_act = rng.randint(0, A, (L, R, 1))
    masks = f32(rng.rand(L, R, 1) > 0.25)
    active = f32(rng.rand(L, R, 1) > 0.2)
    active[0] = 1.0
    inp = dict(
        share_obs=f32(rng.randn(L, R, d[1])), obs=f32(rng.randn(L, R, d[0])), node_obs=node,
        adj=adj, agent_id=rng.randint(0, N, (L, R, 1)).astype(np.int32),
        h_actor=f32(rng.randn(R, 1, 64) * 0.5), h_critic=f32(rng.randn(R, 1, 64) * 0.5),
        actions=np.where(np.take_along_axis(avail, logits_act, -1) > 0, logits_act,
                         A // 2).astype(np.float32),
        value_preds=f32(rng.randn(L, R, 1)), returns=f32(rng.randn(L, R, 1) * 2),
        masks=masks, active_masks=active, old_logp=f32(-3.0 + 0.1 * rng.randn(L, R, 1)),
        adv=f32(rng.randn(L, R, 1)), avail=avail,
    )
    jcfg = JModelConfig(max_edge_dist=ep.cfg.coordination_range, gnn_impl="dense", **TANH)
    jpol = JPolicy(jcfg, JDims(*d))
    jtr = jmappo.GRMAPPOTrainer(jpol, data_chunk_length=L)
    jparams = jax.jit(lambda k: jpol.init_params(k, jnp.float32))(jax.random.PRNGKey(2))
    share_aid = inp["agent_id"]  # unused by the critic's global pool
    jvn_state = jvn.vn_update(jvn.vn_init(jnp.float32), jnp.asarray(inp["returns"]).reshape(-1, 1))

    def jloss(params):
        values, logp, ent = jpol.evaluate_actions(
            params, inp["share_obs"], inp["obs"], inp["node_obs"], inp["adj"], inp["agent_id"],
            share_aid, inp["h_actor"], inp["h_critic"], inp["actions"], inp["masks"],
            inp["avail"], inp["active_masks"], time_major=True)
        ratio = jnp.exp(logp - inp["old_logp"])
        surr = jnp.minimum(ratio * inp["adv"],
                           jnp.clip(ratio, 1.0 - jtr.clip_param, 1.0 + jtr.clip_param) * inp["adv"])
        am = inp["active_masks"]
        pl = -(surr.sum(-1, keepdims=True) * am).sum() / am.sum()
        vl = jmappo.cal_value_loss(
            values, inp["value_preds"], inp["returns"], am, jvn_state,
            clip_param=jtr.clip_param, use_huber_loss=True, huber_delta=jtr.huber_delta,
            use_clipped_value_loss=True, use_value_active_masks=True)
        return pl - ent * jtr.entropy_coef + vl * jtr.value_loss_coef, (values, logp, ent)

    (jtotal, (jv, jlp, jent)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)

    pol = GRMAPPOPolicy(ModelConfig(max_edge_dist=ep.cfg.coordination_range, **TANH),
                        PolicyDims(*d), device="cpu")
    trainer = GRMAPPOTrainer(pol, data_chunk_length=L)
    params = pol.init_params(0)
    sd_a, sd_c = policy_params_from_flax(jax.tree.map(np.asarray, jparams.actor),
                                         jax.tree.map(np.asarray, jparams.critic))
    params.actor.load_state_dict(sd_a)
    params.critic.load_state_dict(sd_c)
    batch = {k: torch.tensor(np.ascontiguousarray(v)) for k, v in inp.items()}
    batch["agent_id"] = batch["agent_id"].to(torch.long)
    values, logp, ent = pol.evaluate_actions(
        params, batch["share_obs"], batch["obs"], batch["node_obs"], batch["adj"],
        batch["agent_id"], batch["h_actor"], batch["h_critic"], batch["actions"],
        batch["masks"], batch["avail"], batch["active_masks"])
    np.testing.assert_allclose(values.detach().numpy(), np.asarray(jv), **NET_TOL)
    np.testing.assert_allclose(logp.detach().numpy(), np.asarray(jlp), **NET_TOL)
    np.testing.assert_allclose(ent.item(), float(jent), **NET_TOL)

    vn = valuenorm.vn_update(valuenorm.vn_init(), batch["returns"].reshape(-1, 1))
    total, _ = trainer.loss(params, vn, batch)
    np.testing.assert_allclose(total.item(), float(jtotal), **NET_TOL)
    for side in ("actor", "critic"):
        module = getattr(params, side)
        names = [n for n, _ in module.named_parameters()]
        got = torch.autograd.grad(total, list(module.parameters()), retain_graph=True,
                                  allow_unused=True)
        want = state_dict_from_flax(jax.tree.map(np.asarray, getattr(jgrads, side)))
        for n, g in zip(names, got):
            g = torch.zeros_like(want[n]) if g is None else g
            assert_leaf_close(g.numpy(), want[n].numpy(), what=f"{side}.{n}")


# ---------------------------------------------------------------- pieces
def test_huber_matches_jax_bug_for_bug():
    """float64, to 1e-12: errors below -delta give zero loss."""
    e = np.linspace(-25.0, 25.0, 101)
    got = mappo.huber(torch.tensor(e), 10.0).numpy()
    np.testing.assert_allclose(got, np.asarray(jmappo.huber(jnp.asarray(e), 10.0)), **F64)
    assert np.all(got[e < -10.0] == 0.0)


@pytest.mark.parametrize("use_huber,clipped,active,with_vn",
                         [(True, True, True, True), (False, True, False, True),
                          (True, False, True, False), (False, False, False, False)])
def test_cal_value_loss_matches_jax(use_huber, clipped, active, with_vn):
    """float64, to 1e-12, every branch."""
    rng = np.random.RandomState(5)
    v, vp, ret = rng.randn(3, 6, 4, 1) * np.array([3.0, 3.0, 15.0])[:, None, None, None]
    am = (rng.rand(6, 4, 1) > 0.3).astype(float)
    kw = dict(clip_param=0.2, use_huber_loss=use_huber, huber_delta=10.0,
              use_clipped_value_loss=clipped, use_value_active_masks=active)
    jstate = jvn.vn_update(jvn.vn_init(jnp.float64), jnp.asarray(rng.randn(16, 1) * 4 + 2))
    want = jmappo.cal_value_loss(*map(jnp.asarray, (v, vp, ret, am)),
                                 jstate if with_vn else None, **kw)
    state = value_norm_from_numpy(jax.tree.map(np.asarray, jstate), dtype=torch.float64)
    got = mappo.cal_value_loss(*map(torch.tensor, (v, vp, ret, am)),
                               state if with_vn else None, **kw)
    np.testing.assert_allclose(got.item(), float(want), **F64)


def test_to_chunks_matches_jax_and_straddles_agents():
    """Exact: 6 steps x 2 envs x 3 agents in windows of 4, so windows cross
    from one agent's sequence into the next, as in the reference."""
    x = np.arange(6 * 2 * 3 * 2, dtype=np.float64).reshape(6, 2, 3, 2)
    got = mappo._to_chunks(torch.tensor(x), 4).numpy()
    want = np.asarray(jmappo._to_chunks(jnp.asarray(x), 4))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (9, 4, 2)
    # window 1 holds steps 4-5 of agent (0, 0) and steps 0-1 of agent (0, 1)
    np.testing.assert_array_equal(got[1, :, 0], x[[4, 5, 0, 1], 0, [0, 0, 1, 1], 0])


def test_valuenorm_matches_jax():
    """float64, to 1e-12: two updates, then normalize and denormalize."""
    rng = np.random.RandomState(6)
    xs = [rng.randn(12, 1) * 3 + 1, rng.randn(7, 1) * 2 - 4]
    js, ts = jvn.vn_init(jnp.float64), valuenorm.vn_init(torch.float64)
    for x in xs:
        js, ts = jvn.vn_update(js, jnp.asarray(x)), valuenorm.vn_update(ts, torch.tensor(x))
    for k in ("running_mean", "running_mean_sq", "debiasing_term"):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), **F64)
    y = rng.randn(5, 1)
    np.testing.assert_allclose(valuenorm.vn_normalize(ts, torch.tensor(y)).numpy(),
                               np.asarray(jvn.vn_normalize(js, jnp.asarray(y))), **F64)
    np.testing.assert_allclose(valuenorm.vn_denormalize(ts, torch.tensor(y)).numpy(),
                               np.asarray(jvn.vn_denormalize(js, jnp.asarray(y))), **F64)


def test_popart_matches_jax():
    """float64, to 1e-12: two updates with their v_out rescales, then
    normalize and denormalize (also through the value-norm dispatch)."""
    rng = np.random.RandomState(7)
    js, ts = jpopart.popart_init(jnp.float64), popart.popart_init(torch.float64)
    w, b = rng.randn(64, 1), rng.randn(1)
    jv = {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}
    lin = torch.nn.Linear(64, 1, dtype=torch.float64)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(w.T))
        lin.bias.copy_(torch.tensor(b))
    for x in (rng.randn(10, 1) * 5 + 3, rng.randn(6, 1) * 2):
        js, jscale, jshift = jpopart.popart_update(js, jnp.asarray(x))
        jv = jpopart.rescale_v_out(jv, jscale, jshift)
        ts, scale, shift = popart.popart_update(ts, torch.tensor(x))
        popart.rescale_v_out(lin, scale, shift)
    for k in ("mean", "mean_sq", "stddev", "debiasing_term"):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), **F64)
    np.testing.assert_allclose(lin.weight.detach().numpy().T, np.asarray(jv["kernel"]), **F64)
    np.testing.assert_allclose(lin.bias.detach().numpy(), np.asarray(jv["bias"]), **F64)
    y = rng.randn(5, 1)
    np.testing.assert_allclose(valuenorm.vn_normalize(ts, torch.tensor(y)).numpy(),
                               np.asarray(jvn.vn_normalize(js, jnp.asarray(y))), **F64)
    np.testing.assert_allclose(valuenorm.vn_denormalize(ts, torch.tensor(y)).numpy(),
                               np.asarray(jvn.vn_denormalize(js, jnp.asarray(y))), **F64)


@pytest.mark.parametrize("scale", [5.0, 0.5])
def test_clip_by_global_norm_is_optax(scale):
    """float64, to 1e-12, against optax's ``clip_by_global_norm(10)``: a
    global norm above 10 (scale 5) is scaled to exactly 10 by g / norm * 10,
    not by torch's ``clip_grad_norm_`` factor 10 / (norm + 1e-6); a norm
    below 10 (scale 0.5) leaves the gradients as they are."""
    rng = np.random.RandomState(8)
    gs = [rng.randn(7, 3) * scale, rng.randn(11) * scale]
    norm = np.sqrt(sum((g**2).sum() for g in gs))
    assert (norm > 10.0) == (scale > 1.0)
    want, _ = optax.clip_by_global_norm(10.0).update([jnp.asarray(g) for g in gs], None)
    got = [torch.tensor(g) for g in gs]
    n = mappo.clip_by_global_norm(got, 10.0)
    np.testing.assert_allclose(n.item(), norm, **F64)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F64)
    if scale > 1.0:
        np.testing.assert_allclose(np.sqrt(sum((g.numpy() ** 2).sum() for g in got)), 10.0, **F64)
        ref = [torch.tensor(g, requires_grad=True) for g in gs]
        for r, g in zip(ref, gs):
            r.grad = torch.tensor(g)
        torch.nn.utils.clip_grad_norm_(ref, 10.0)
        assert not np.allclose(ref[0].grad.numpy(), got[0].numpy(), rtol=1e-9, atol=0)


def _small_update_setup(use_popart):
    ep, _ = port_trainer()
    pol = GRMAPPOPolicy(ModelConfig(max_edge_dist=ep.cfg.coordination_range, **TANH),
                        PolicyDims(*dims_of(ep)), device="cpu")
    trainer = GRMAPPOTrainer(pol, ppo_epoch=1, num_mini_batch=1, data_chunk_length=L,
                             use_popart=use_popart)
    ts = trainer.init_state(3)
    runner = Runner(env_params=ep, policy=pol, trainer=trainer, n_rollout_threads=B,
                    episode_length=T, device="cpu")
    _, buf, _ = runner.collect(ts, runner.init_carry(5))
    buf = dataclasses.replace(buf, returns=buf.returns * 20 + 7)  # move the statistics
    return trainer, ts, buf


def test_popart_rescales_v_out_after_the_backward_before_the_step():
    """PopArt order (graph_mappo.py:202-210): the loss and its gradient use
    the old v_out and the updated statistics; v_out is rescaled, then the
    first Adam step moves it by -lr * g / (|g| + eps).  Exact up to float32
    rounding (rtol 1e-5 / atol 1e-7); the other order differs."""
    trainer, ts, buf = _small_update_setup(use_popart=True)
    batch = trainer._time_major(trainer.chunks(ts, buf))
    vn_new, scale, shift = popart.popart_update(ts.vn, batch["returns"].reshape(-1, 1))
    total, _ = trainer.loss(ts.params, vn_new, batch)
    v_out = ts.params.critic.v_out
    critic = list(ts.params.critic.parameters())
    grads = torch.autograd.grad(total, critic, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(critic, grads)]
    mappo.clip_by_global_norm(grads, trainer.policy.max_grad_norm)
    gw = grads[[i for i, p in enumerate(critic) if p is v_out.weight][0]]
    gb = grads[[i for i, p in enumerate(critic) if p is v_out.bias][0]]
    lr, eps = trainer.policy.critic_lr, trainer.policy.opti_eps
    old_w, old_b = v_out.weight.detach().clone(), v_out.bias.detach().clone()
    old_std, old_mean, new_mean, new_std = shift
    want_w = old_w * scale - lr * gw / (gw.abs() + eps)
    want_b = (old_std * old_b + old_mean - new_mean) / new_std - lr * gb / (gb.abs() + eps)
    wrong_w = (old_w - lr * gw / (gw.abs() + eps)) * scale
    assert abs(scale.item() - 1.0) > 1e-3
    trainer._minibatch_update(ts, batch)
    torch.testing.assert_close(v_out.weight.detach(), want_w, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(v_out.bias.detach(), want_b, rtol=1e-5, atol=1e-7)
    assert not torch.allclose(v_out.weight.detach(), wrong_w, rtol=1e-5, atol=1e-7)
    for k in ("mean", "mean_sq", "stddev", "debiasing_term"):
        torch.testing.assert_close(getattr(ts.vn, k), getattr(vn_new, k), rtol=0, atol=0)


def test_train_with_minibatches_draws_from_the_generator():
    """num_mini_batch > 1: per epoch a ``torch.randperm`` on the explicit
    generator picks the chunks; the same seed gives the same weights
    (exactly), another seed others, and the infos are finite."""
    outs = []
    for seed in (11, 11, 12):
        trainer, ts, buf = _small_update_setup(use_popart=False)
        trainer = dataclasses.replace(trainer, num_mini_batch=2, ppo_epoch=2)
        ts, info = trainer.train(ts, buf, torch.Generator().manual_seed(seed))
        assert all(np.isfinite(v.item()) for v in info.values())
        outs.append(torch.cat([p.detach().reshape(-1) for p in ts.params.actor.parameters()]))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="generator"):
        trainer.train(ts, buf)
