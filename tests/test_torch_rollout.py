"""The torch port's rollout against the JAX package's: one ``Runner.collect``
window, T = 8 steps over 4 envs, env in float64, on the CPU.

Both start from the same ``RolloutCarry`` (the JAX one, converted) with the
same parameters.  Sampling draws differ between the frameworks, so the
port's ``distributions.sample`` is replaced by the JAX run's actions, step
by step.  The env side of the buffer is held at 1e-9 (as
``tests/test_golden_parity.py:143-161``), the policy side (values, log-probs,
RNN states, returns) at rtol 2e-4 / atol 2e-5.  The JAX runner uses its dense
trunk (the JAX package's own CPU runner tests do, for compile time); the
port's transposed trunk computes the same function at that bar.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contracts_marl_aam_corridors_tpu.config.physics import vehicle_config as jvehicle
from contracts_marl_aam_corridors_tpu.envs.types import EnvParams as JEnvParams
from contracts_marl_aam_corridors_tpu.learner.mappo import GRMAPPOTrainer as JTrainer
from contracts_marl_aam_corridors_tpu.learner.runner import Runner as JRunner
from contracts_marl_aam_corridors_tpu.models import GRMAPPOPolicy as JPolicy
from contracts_marl_aam_corridors_tpu.models import ModelConfig as JModelConfig
from contracts_marl_aam_corridors_tpu.models import PolicyDims as JDims

from contracts_marl_aam_corridors_tpu_torch.config.physics import vehicle_config
from contracts_marl_aam_corridors_tpu_torch.envs.types import EnvParams, env_state_from_numpy
from contracts_marl_aam_corridors_tpu_torch.learner import (
    GRMAPPOTrainer,
    RolloutCarry,
    Runner,
    TrainState,
    vn_init,
)
from contracts_marl_aam_corridors_tpu_torch.models import (
    GRMAPPOPolicy,
    ModelConfig,
    PolicyDims,
    distributions,
    policy_params_from_flax,
)

torch.set_num_threads(1)

ENV_TOL = dict(atol=1e-9, rtol=0)
NET_TOL = dict(rtol=2e-4, atol=2e-5)
B, T = 4, 8
CPU = torch.device("cpu")
# the metrics of the JAX package's eval_episode (learner/runner.py:349-366)
EVAL_KEYS = {
    "eval_average_episode_rewards", "eval_success_rate", "eval_all_success_rate",
    "eval_num_agent_collisions", "eval_conformance", "eval_time_mean",
    "eval_dist_to_goal", "eval_phase_reached", "eval_gate_success_rate",
    "eval_all_gate_success_rate",
}


def dims_of(ep):
    return (ep.obs_dim, ep.obs_dim * ep.num_agents, ep.num_entities, ep.node_feat_dim,
            ep.num_actions)


def port_setup(ep_len, jparams=None):
    ep = EnvParams(cfg=vehicle_config("air_taxi"), episode_length=ep_len)
    pol = GRMAPPOPolicy(ModelConfig(max_edge_dist=ep.cfg.coordination_range),
                        PolicyDims(*dims_of(ep)), device="cpu")
    params = pol.init_params(0)
    if jparams is not None:
        sd_a, sd_c = policy_params_from_flax(jax.tree.map(np.asarray, jparams.actor),
                                             jax.tree.map(np.asarray, jparams.critic))
        params.actor.load_state_dict(sd_a)
        params.critic.load_state_dict(sd_c)
    return ep, pol, TrainState(params=params, vn=vn_init(torch.float64, CPU))


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
        env_state=env_state_from_numpy(fields, CPU, torch.float64),
        obs=t(jc.obs), node_obs=t(jc.node_obs), adj=t(jc.adj),
        agent_id=t(jc.agent_id).to(torch.long),
        rnn_actor=t(jc.rnn_actor), rnn_critic=t(jc.rnn_critic), masks=t(jc.masks),
        active_masks=t(jc.active_masks), bad_masks=t(jc.bad_masks),
        prev_done=t(jc.prev_done), gen=torch.Generator().manual_seed(0),
    )


def test_collect_window_matches_jax(monkeypatch):
    jep = JEnvParams(cfg=jvehicle("air_taxi"), episode_length=25)
    jcfg = JModelConfig(max_edge_dist=jep.cfg.coordination_range, gnn_impl="dense")
    jpol = JPolicy(jcfg, JDims(*dims_of(jep)))
    jtrainer = JTrainer(jpol)
    jts = jax.jit(jtrainer.init_state)(jax.random.PRNGKey(0))
    jrunner = JRunner(env_params=jep, policy=jpol, trainer=jtrainer, n_rollout_threads=B,
                      episode_length=T, dtype=jnp.float64)
    jcarry = jax.jit(jrunner.init_carry)(jax.random.PRNGKey(4))
    jcarry2, jbuf, jinfo = jax.jit(jrunner.collect)(jts, jcarry)
    # no env finished inside the window, so no auto-reset draw is involved
    assert np.all(np.asarray(jbuf.masks) == 1.0)

    ep, pol, ts = port_setup(25, jts.params)
    runner = Runner(env_params=ep, policy=pol, trainer=GRMAPPOTrainer(pol),
                    n_rollout_threads=B, episode_length=T, dtype=torch.float64, device="cpu")
    jactions = np.asarray(jbuf.actions).astype(np.int64)  # (T, B, N, 1)
    step = iter(range(T))

    def replay(gen, logits):
        a = torch.tensor(jactions[next(step)]).reshape(-1, 1)
        assert a.shape[0] == logits.shape[0]
        return a

    monkeypatch.setattr(distributions, "sample", replay)
    carry2, buf, info = runner.collect(ts, carry_from_jax(jcarry))

    env_side = ("share_obs", "obs", "node_obs", "adj", "agent_id", "actions", "rewards",
                "masks", "active_masks", "bad_masks", "available_actions")
    net_side = ("value_preds", "action_log_probs", "returns", "rnn_states",
                "rnn_states_critic")
    for k in env_side + net_side:
        got, want = getattr(buf, k).numpy(), np.asarray(getattr(jbuf, k))
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, err_msg=k,
                                   **(ENV_TOL if k in env_side else NET_TOL))
    assert set(info) == set(jinfo)
    for k in info:
        np.testing.assert_allclose(info[k].numpy(), np.asarray(jinfo[k]), err_msg=k, **ENV_TOL)
    np.testing.assert_allclose(carry2.obs.numpy(), np.asarray(jcarry2.obs), **ENV_TOL)


def test_eval_episode_runs_end_to_end():
    ep, pol, ts = port_setup(6)
    runner = Runner(env_params=ep, policy=pol, trainer=GRMAPPOTrainer(pol),
                    n_rollout_threads=2, episode_length=6, device="cpu")
    out = runner.eval_episode(ts, seed=5, n_eval=4)
    assert set(out) == EVAL_KEYS
    assert all(np.isfinite(v) for v in out.values())
    assert 0.0 <= out["eval_all_success_rate"] <= out["eval_success_rate"] <= 1.0
    assert 0.0 <= out["eval_all_gate_success_rate"] <= out["eval_gate_success_rate"] <= 1.0
    # deterministic policy + same seed => identical metrics
    assert runner.eval_episode(ts, seed=5, n_eval=4) == out


@pytest.mark.parametrize("use_gae", [True, False])
@pytest.mark.parametrize("proper", [True, False])
def test_compute_returns_matches_jax(use_gae, proper):
    from contracts_marl_aam_corridors_tpu.learner import buffer as jbuffer
    from contracts_marl_aam_corridors_tpu.learner.valuenorm import vn_init as jvn_init
    from contracts_marl_aam_corridors_tpu.learner.valuenorm import vn_update as jvn_update

    from contracts_marl_aam_corridors_tpu_torch.learner import buffer

    rng = np.random.RandomState(11)
    Tn, Bn, Nn = 6, 3, 2
    shp = (Tn + 1, Bn, Nn, 1)
    arrs = dict(
        rewards=rng.randn(Tn, Bn, Nn, 1), value_preds=rng.randn(*shp),
        masks=(rng.rand(*shp) > 0.3).astype(float), bad_masks=(rng.rand(*shp) > 0.3).astype(float),
        returns=rng.randn(*shp),
    )
    nv = rng.randn(Bn, Nn, 1)
    jvn = jvn_update(jvn_init(jnp.float64), jnp.asarray(rng.randn(32, 1) * 3 + 1))
    filler = dict(share_obs=0, obs=0, node_obs=0, adj=0, agent_id=0, rnn_states=0,
                  rnn_states_critic=0, actions=0, action_log_probs=0, active_masks=0,
                  available_actions=0)
    jb = jbuffer.RolloutBuffer(**{k: jnp.asarray(v) for k, v in arrs.items()},
                               **{k: jnp.zeros(1) for k in filler})
    want = jbuffer.compute_returns(jb, jnp.asarray(nv), jvn, 0.99, 0.95, use_gae=use_gae,
                                   use_proper_time_limits=proper)
    vn = vn_init(torch.float64, CPU)
    vn = dataclasses.replace(vn, running_mean=torch.tensor(np.asarray(jvn.running_mean)),
                             running_mean_sq=torch.tensor(np.asarray(jvn.running_mean_sq)),
                             debiasing_term=torch.tensor(np.asarray(jvn.debiasing_term)))
    tb = buffer.RolloutBuffer(**{k: torch.tensor(v) for k, v in arrs.items()},
                              **{k: torch.zeros(1) for k in filler})
    got = buffer.compute_returns(tb, torch.tensor(nv), vn, 0.99, 0.95, use_gae=use_gae,
                                 use_proper_time_limits=proper)
    for k in ("returns", "value_preds"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-12, atol=1e-12, err_msg=k)
