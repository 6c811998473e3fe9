"""The torch port's warm start (``utils/checkpoint.py warm_start_params``,
``cli/train.py --warm_start_dir``) against the JAX package's, on the CPU.

The port warm-starts from the converted rot_inv checkpoint
(``model_weights_torch/rot_inv/airtaxi``, made by
``scripts/orbax_to_torch.py rot_inv``), the JAX package from the orbax
original (``model_weights/rot_inv/airtaxi``), both into a fresh three_phase
state of the shipped three_phase recipe: every weight, the 13 -> 15
observation remap included, and the PopArt state must be equal, leaf for
leaf and exactly; the optimizers stay fresh.  Also: the same scenario is an
identity on the weights, a value-norm kind that differs keeps the fresh
normalizer, an orbax directory and a reference ``actor.pt`` directory are
refused with errors that say what to do, and the train CLI warm-starts a
three_phase run whose checkpoint the eval CLI then evaluates.
"""
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from contracts_marl_aam_corridors_tpu.cli.train import build as jbuild
from contracts_marl_aam_corridors_tpu.config import flags as jflags
from contracts_marl_aam_corridors_tpu.utils import checkpoint as jcheckpoint

from contracts_marl_aam_corridors_tpu_torch.cli import eval as cli_eval
from contracts_marl_aam_corridors_tpu_torch.cli import train as cli_train
from contracts_marl_aam_corridors_tpu_torch.cli.train import build
from contracts_marl_aam_corridors_tpu_torch.config.flags import parse_all
from contracts_marl_aam_corridors_tpu_torch.learner import PopArtState, ValueNormState
from contracts_marl_aam_corridors_tpu_torch.models.convert import state_dict_from_flax
from contracts_marl_aam_corridors_tpu_torch.utils import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import orbax_to_torch  # noqa: E402

torch.set_num_threads(1)

JAX_SRC = os.path.join(ROOT, "model_weights", "rot_inv", "airtaxi")
PORT_SRC = os.path.join(ROOT, "model_weights_torch", "rot_inv", "airtaxi")


def _port_state(argv, src=PORT_SRC):
    """A fresh port TrainState of ``argv`` with the source's activation
    flags, as the train CLI builds it; and its env params."""
    args = parse_all(argv)
    for k, v in checkpoint.arch_act_flags(src).items():
        setattr(args, k, v)
    env_params, _, trainer, _ = build(args, "cpu")
    return env_params, trainer.init_state(0)


def test_obs_index_map_and_remap_rows_match_jax():
    for dims in ((13, 15), (13, 13), (15, 15)):
        assert checkpoint._obs_index_map(*dims) == jcheckpoint._obs_index_map(*dims)
    full = checkpoint._obs_index_map(13, 15) + list(range(13, 29))
    rng = np.random.RandomState(0)
    for shape, fill in (((29,), 1.0), ((29, 64), 0.0)):
        old = rng.randn(*shape).astype(np.float32)
        want = jcheckpoint._remap_rows(old, full, fill)
        got = checkpoint._remap_rows(torch.tensor(old), full, fill)
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.shape[0] == 31


def test_warm_start_into_three_phase_matches_jax():
    argv = orbax_to_torch.recipe("three_phase")
    # the JAX package: its CLI's flag adoption, build, fresh state, warm start
    jargs = jflags.parse_all(argv)
    for k, v in jcheckpoint.warm_start_arch_flags(JAX_SRC).items():
        setattr(jargs, k, v)
    jenv, jpolicy, jtrainer, _ = jbuild(jargs)
    # jitted, the fresh state takes a third of the CPU time it takes op by op
    fresh = jax.jit(jtrainer.init_state)(jax.random.PRNGKey(1))
    jts = jcheckpoint.warm_start_params(JAX_SRC, fresh, jenv.obs_dim, cfg=jpolicy.cfg)
    env_params, ts = _port_state(argv)
    assert env_params.obs_dim == jenv.obs_dim == 15
    ts = checkpoint.warm_start_params(PORT_SRC, ts, env_params.obs_dim)

    for side in ("actor", "critic"):
        want = state_dict_from_flax(jax.tree.map(np.asarray, dict(getattr(jts.params, side))))
        got = getattr(ts.params, side).state_dict()
        assert set(got) == set(want), side
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), f"{side}.{k}"
    # the two inserted observation rows: LayerNorm scale 1 and bias 0, fc0 zero
    a = ts.params.actor.state_dict()
    assert torch.all(a["base.feature_norm.weight"][12:14] == 1.0)
    assert torch.all(a["base.feature_norm.bias"][12:14] == 0.0)
    assert torch.all(a["base.mlp.fc0.weight"][:, 12:14] == 0.0)
    # the PopArt state is the checkpoint's, as the JAX package's
    assert isinstance(ts.vn, PopArtState)
    for f in dataclasses.fields(ts.vn):
        w = getattr(jts.vn, f.name)
        g = getattr(ts.vn, f.name)
        if isinstance(g, torch.Tensor):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f.name)
        else:
            assert g == w, f.name
    assert float(ts.vn.debiasing_term) > 0
    # fresh optimizers on both sides
    assert not ts.actor_opt.state and not ts.critic_opt.state
    counts = [int(np.asarray(x)) for x in jax.tree.leaves(jts.actor_opt)
              if np.asarray(x).shape == () and np.asarray(x).dtype == np.int32]
    assert counts and not any(counts)


def test_warm_start_same_scenario_is_identity():
    """rot_inv into rot_inv: the checkpoint's weights and normalizer as a
    restore gives them, the optimizers fresh."""
    _, ts = _port_state(orbax_to_torch.recipe("rot_inv"))
    ts = checkpoint.warm_start_params(PORT_SRC, ts, 13)
    _, tmpl = _port_state(orbax_to_torch.recipe("rot_inv"))
    restored, episode = checkpoint.restore_checkpoint(PORT_SRC, tmpl)
    assert episode == 950 and restored.actor_opt.state
    for side in ("actor", "critic"):
        got, want = (getattr(t.params, side).state_dict() for t in (ts, restored))
        assert all(torch.equal(got[k], want[k]) for k in want), side
    assert all(torch.equal(getattr(ts.vn, f.name), getattr(restored.vn, f.name))
               for f in dataclasses.fields(ts.vn) if f.name not in ("beta", "epsilon"))
    assert not ts.actor_opt.state and not ts.critic_opt.state


def test_warm_start_value_norm_mismatch_keeps_fresh():
    """A ValueNorm run warm-started from the PopArt checkpoint keeps its
    fresh normalizer and takes the weights."""
    # --use_valuenorm is a store_false flag (the reference's idiom): without
    # it and without --use_popart the run keeps a ValueNorm
    argv = [a for a in orbax_to_torch.recipe("three_phase")
            if a not in ("--use_popart", "--use_valuenorm")]
    env_params, ts = _port_state(argv)
    assert isinstance(ts.vn, ValueNormState)
    fresh = {f.name: getattr(ts.vn, f.name) for f in dataclasses.fields(ts.vn)}
    fresh = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in fresh.items()}
    ts = checkpoint.warm_start_params(PORT_SRC, ts, env_params.obs_dim)
    assert isinstance(ts.vn, ValueNormState)
    for k, v in fresh.items():
        g = getattr(ts.vn, k)
        assert (torch.equal(g, v) if isinstance(v, torch.Tensor) else g == v), k
    state = torch.load(os.path.join(PORT_SRC, "ckpt_950", "train_state.pt"),
                       map_location="cpu", weights_only=True)
    got = ts.params.critic.state_dict()
    assert all(torch.equal(got[k], v) for k, v in state["critic"].items())


def test_warm_start_refuses_sources_it_cannot_read(tmp_path):
    _, ts = _port_state(orbax_to_torch.recipe("three_phase"))
    with pytest.raises(ValueError, match="orbax_to_torch.py") as err:
        checkpoint.warm_start_params(JAX_SRC, ts, 15)
    assert os.path.join("model_weights_torch", "rot_inv", "airtaxi") in str(err.value)
    (tmp_path / "actor.pt").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A11"):
        checkpoint.warm_start_params(str(tmp_path), ts, 15)


def test_cli_warm_starts_three_phase_and_evaluates_it(tmp_path):
    """The train CLI on three_phase from the rot_inv checkpoint (its tanh
    activations adopted over the command line's relu), fresh optimizers,
    episode 0; then the eval CLI on the run it saved."""
    argv = ["--scenario_name", "three_phase_graph", "--dynamics_type", "air_taxi",
            "--num_agents", "3", "--world_size", "4", "--total_actions", "9",
            "--use_popart", "--n_rollout_threads", "4", "--episode_length", "4",
            "--ppo_epoch", "1", "--num_env_steps", "16", "--compute_dtype", "float32",
            "--cuda", "--seed", "1", "--run_dir", str(tmp_path),
            "--warm_start_dir", PORT_SRC]
    run_dir, ts = cli_train.main(argv)
    models = os.path.join(run_dir, "models")
    cfg = checkpoint.load_run_config(models)
    assert cfg["warm_start_dir"] == PORT_SRC
    assert (cfg["use_ReLU"], cfg["embed_use_ReLU"], cfg["gnn_use_ReLU"]) == (False,) * 3
    assert sorted(os.listdir(models)) == ["ckpt_0", "config.json", "latest.json"]
    assert all(int(st["step"]) == 1 for st in ts.actor_opt.state.values())
    # the scenario, like the env shape, is the command line's (merge_eval_args)
    rows = cli_eval.main(["--model_dir", models, "--scenario_name", "three_phase_graph",
                          "--num_agents", "3", "--episode_length", "4",
                          "--render_episodes", "1", "--cuda",
                          "--run_dir", str(tmp_path / "eval")])
    assert len(rows) == 1 and np.isfinite(rows[0]["ep_rew"])
