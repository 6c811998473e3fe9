"""The torch port's train and eval entry points (``config/flags.py``,
``utils/checkpoint.py``, ``utils/logging.py``, ``cli/train.py``,
``cli/eval.py``) on the CPU.

The flags parse as the JAX package's do and build the same configurations on
the fields the port carries; settings the port lacks are refused, each
naming its ROADMAP item; a short run with ``--cuda`` (the reference's
store_false flag: the CPU) writes the JAX package's run layout, its
checkpoint restores bit for bit, and ``--model_dir`` restarts at the saved
episode, as the JAX package's CLI does.  The eval CLI evaluates the shipped
july checkpoint (``model_weights_torch/july/unicycle``), merges its run's
flags as the JAX package's ``merge_eval_args`` does, and writes the JAX
package's ``eval_stats.csv`` columns.  The curriculum's schedule equals the
JAX CLI's (that CLI run with its build and episode step stubbed), the
safety filters train and evaluate through both CLIs, and a critic fed each
agent's own observation where the layers expect the shared one is refused
where the JAX package's stops on the shape.
"""
import csv
import dataclasses
import json
import os
import sys

import flax
import jax
import jax.numpy as jnp
import pytest
import torch

from contracts_marl_aam_corridors_tpu.cli import train as jcli_train
from contracts_marl_aam_corridors_tpu.config import flags as jflags
from contracts_marl_aam_corridors_tpu.utils import checkpoint as jcheckpoint

from contracts_marl_aam_corridors_tpu_torch.cli import eval as cli_eval
from contracts_marl_aam_corridors_tpu_torch.cli import train as cli_train
from contracts_marl_aam_corridors_tpu_torch.config import flags
from contracts_marl_aam_corridors_tpu_torch.envs import env as tenv
from contracts_marl_aam_corridors_tpu_torch.learner import PopArtState, ValueNormState
from contracts_marl_aam_corridors_tpu_torch.ops import gnn_trunk
from contracts_marl_aam_corridors_tpu_torch.utils import checkpoint as tcheckpoint
from contracts_marl_aam_corridors_tpu_torch.utils.checkpoint import (
    _resolve_ckpt_path,
    load_run_config,
    merge_eval_args,
    restore_checkpoint,
    warm_start_params,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from july_eval import recipe as july_recipe  # noqa: E402

torch.set_num_threads(1)

FLAGSHIP = ["--num_agents", "3", "--n_rollout_threads", "1024", "--episode_length", "25",
            "--ppo_epoch", "15", "--num_mini_batch", "1", "--data_chunk_length", "10"]
# the shipped july checkpoint's recipe: unicycle, world 4, 9 actions
ARGVS = {"default": [], "flagship": FLAGSHIP, "july_unicycle": july_recipe(150)}
# the runs and comparisons written before the port computed in bfloat16 pin
# float32, so that they go on holding what they held
FLOAT32 = ["--compute_dtype", "float32"]


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_flags_parse_as_jax(name):
    argv = ARGVS[name]
    assert vars(flags.parse_all(argv)) == vars(jflags.parse_all(argv))


def _same(a, b) -> bool:
    if dataclasses.is_dataclass(a):
        return dataclasses.asdict(a) == dataclasses.asdict(b)
    return a == b


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_built_configs_match_jax(name):
    """Field by field on the fields of the port's EnvParams and
    ModelConfig; both builders set max_edge_dist to the coordination
    range."""
    argv = ARGVS[name] + FLOAT32
    targs, jargs = flags.parse_all(argv), jflags.parse_all(argv)
    tenv, jenv = flags.build_env_params(targs), jflags.build_env_params(jargs)
    for f in dataclasses.fields(tenv):
        assert _same(getattr(tenv, f.name), getattr(jenv, f.name)), f.name
    assert targs.max_edge_dist == jargs.max_edge_dist == tenv.cfg.coordination_range
    tcfg, jcfg = flags.build_model_config(targs), jflags.build_model_config(jargs)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


# the gated scenarios' names, as the shipped checkpoints' runs give them
GATED = ["nav_graph_metered_single_corridor_rot_inv", "three_phase_graph", "two_phase_graph",
         "old_two_graph"]


@pytest.mark.parametrize("scenario_name", GATED)
def test_gated_env_params_match_jax(scenario_name):
    """The port's ``build_env_params`` equals the JAX package's for each
    gated scenario name, on every field and derived property the port's
    EnvParams carries."""
    argv = ["--scenario_name", scenario_name, "--world_size", "4"] + FLOAT32
    tenv = flags.build_env_params(flags.parse_all(argv))
    jenv = jflags.build_env_params(jflags.parse_all(argv))
    for f in dataclasses.fields(tenv):
        assert _same(getattr(tenv, f.name), getattr(jenv, f.name)), f.name
    for k in ("obs_dim", "node_feat_dim", "num_entities", "num_actions", "exit_back",
              "randomize_tube_length", "spawn_jitter_scale", "spawn_spacing_div",
              "cooldown_steps"):
        assert getattr(tenv, k) == getattr(jenv, k), k
    assert tenv.gated and tenv.node_feat_dim == 7


# the settings ported since the refusals were first written: each builds what
# the JAX package builds (the integrator is read from no flag, so a
# namespace that carries one still gives closed_form, as there)
V4OCT = "nav_metered_one_goal_graph_rotate_tube_v4oct"
PORTED = {
    "v4oct": ["--scenario_name", V4OCT],
    "double_integrator": ["--dynamics_type", "double_integrator"],
    "rk45": [],
    # BASELINE config 2's env, and 10 agents with walls (config 4 without
    # its safety filter)
    "obstacles": ["--num_obstacles", "3", "--num_agents", "5", "--num_landmarks", "5"],
    "walls": ["--num_walls", "2", "--num_agents", "10", "--num_landmarks", "10",
              "--dynamics_type", "double_integrator"],
    "formation": ["--formation_type", "circle"],
    "bfloat16": ["--compute_dtype", "bfloat16"],
    # the safety filters: the default air taxi's HJ, BASELINE config 4's env
    # with the exponential CBF, and ORCA
    "safety_hj": ["--use_safety_filter", "True"],
    "safety_exp_cbf": ["--num_walls", "2", "--num_agents", "10", "--num_landmarks", "10",
                       "--dynamics_type", "double_integrator", "--world_size", "4",
                       "--use_safety_filter", "True", "--safety_filter_type", "exp_cbf"],
    "safety_rvo": ["--dynamics_type", "double_integrator", "--use_safety_filter", "True",
                   "--safety_filter_type", "rvo"],
    # the runner options
    "curriculum": ["--use_curriculum", "True"],
    "centralized_v_off": ["--use_centralized_V"],
    # the dense per-graph GNN's routes
    "dense_gnn": ["--gnn_impl", "dense"],
    "concat_heads": ["--gnn_concat_heads"],
    "actor_aggr": ["--actor_graph_aggr", "global", "--global_aggr_type", "max"],
    # the dense route's two layout flags, which the kernel route ignores
    "edge_packed": ["--gnn_edge_packed", "True"],
    "fuse_trunks": ["--fuse_gnn_trunks", "True"],
}


@pytest.mark.parametrize("name", sorted(PORTED))
def test_ported_env_params_match_jax(name):
    """The row's settings build the JAX package's EnvParams and
    ModelConfig, field for field."""
    argv = FLOAT32 + PORTED[name]
    targs, jargs = flags.parse_all(argv), jflags.parse_all(argv)
    if name == "rk45":
        targs.integrator = jargs.integrator = "rk45"
    tenv, jenv = flags.build_env_params(targs), jflags.build_env_params(jargs)
    for f in dataclasses.fields(tenv):
        assert _same(getattr(tenv, f.name), getattr(jenv, f.name)), f.name
    for k in ("obs_dim", "node_feat_dim", "num_entities", "num_actions",
              "spawn_jitter_range", "fixed_tube_angle"):
        assert getattr(tenv, k) == getattr(jenv, k), k
    assert tenv.integrator == "closed_form"
    assert (tenv.scenario, tenv.num_actions, tenv.num_entities, tenv.node_feat_dim) == {
        "v4oct": ("v4oct", 25, 5, 8), "double_integrator": ("rotate_tube_july", 5, 5, 8),
        "rk45": ("rotate_tube_july", 25, 5, 8), "obstacles": ("rotate_tube_july", 25, 13, 8),
        "walls": ("rotate_tube_july", 5, 22, 13), "formation": ("rotate_tube_july", 25, 5, 8),
        "bfloat16": ("rotate_tube_july", 25, 5, 8), "safety_hj": ("rotate_tube_july", 25, 5, 8),
        "safety_exp_cbf": ("rotate_tube_july", 5, 22, 13),
        "safety_rvo": ("rotate_tube_july", 5, 5, 8), "curriculum": ("rotate_tube_july", 25, 5, 8),
        "centralized_v_off": ("rotate_tube_july", 25, 5, 8),
        "dense_gnn": ("rotate_tube_july", 25, 5, 8), "concat_heads": ("rotate_tube_july", 25, 5, 8),
        "actor_aggr": ("rotate_tube_july", 25, 5, 8), "edge_packed": ("rotate_tube_july", 25, 5, 8),
        "fuse_trunks": ("rotate_tube_july", 25, 5, 8)}[name]
    tcfg, jcfg = flags.build_model_config(targs), jflags.build_model_config(jargs)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tenv.formation_type == ("circle" if name == "formation" else "point")
    assert tcfg.compute_dtype == ("bfloat16" if name == "bfloat16" else "float32")
    assert (tenv.use_safety_filter, tenv.safety_filter_type) == {
        "safety_hj": (True, "hj"), "safety_exp_cbf": (True, "exp_cbf"),
        "safety_rvo": (True, "rvo")}.get(name, (False, "hj"))
    dense = name in ("dense_gnn", "concat_heads", "actor_aggr")
    assert tcfg.kernel_trunk == (not dense) == jpolicy_routable(jargs)
    _, policy, _, runner = cli_train.build(targs, "cpu")
    assert runner.use_centralized_v == (name != "centralized_v_off") == targs.use_centralized_V
    assert (runner.hj_data is not None) == (name == "safety_hj")
    assert policy.cfg.gnn_out_dim == (48 if name == "concat_heads" else 16)
    assert tcfg.gnn_edge_packed == (name == "edge_packed")
    # the policy flag, against the JAX train CLI's build of the same flags;
    # on the kernel route neither flag changes the trunk's route
    jpolicy = jcli_train.build(jargs)[1]
    assert policy.fuse_gnn_trunks == jpolicy.fuse_gnn_trunks == (name == "fuse_trunks")
    assert not policy._fused_routable()


def jpolicy_routable(jargs) -> bool:
    """The JAX policy's routing of the flags (its trunk kernels or its dense
    per-graph GNN), read from a built policy without compiling anything."""
    from contracts_marl_aam_corridors_tpu.models import GRMAPPOPolicy as JPolicy
    from contracts_marl_aam_corridors_tpu.models import PolicyDims as JDims

    return JPolicy(jflags.build_model_config(jargs), JDims(19, 57, 5, 8, 25))._transposed_routable()


def test_compute_dtype_defaults_as_jax():
    """No --compute_dtype: bfloat16 in both packages' ModelConfig; a
    ModelConfig built in code computes in float32, as the JAX package's, and
    refuses another dtype."""
    tcfg = flags.build_model_config(flags.parse_all([]))
    jcfg = jflags.build_model_config(jflags.parse_all([]))
    assert tcfg.compute_dtype == jcfg.compute_dtype == "bfloat16"
    from contracts_marl_aam_corridors_tpu.models import ModelConfig as JModelConfig
    from contracts_marl_aam_corridors_tpu_torch.models import ModelConfig

    assert ModelConfig().compute_dtype == JModelConfig().compute_dtype == "float32"
    with pytest.raises(ValueError, match="compute_dtype"):
        ModelConfig(compute_dtype="float16")


def test_gated_scenario_with_walls_is_refused(tmp_path):
    """A gated scenario with walls has node rows without the walls and an
    adjacency with them (the JAX train CLI fails on the reshape):
    ``EnvParams`` refuses it, naming both counts, before the run writes
    anything."""
    argv = FLOAT32 + ["--scenario_name", GATED[0], "--num_walls", "1", "--num_obstacles", "1"]
    # 3 agents, the default 2 landmarks and 1 obstacle
    with pytest.raises(ValueError, match=r"n \+ l \+ o = 6 .* n \+ l \+ o \+ w = 7"):
        cli_train.main(argv + ["--cuda", "--run_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir()), "a refused run writes nothing"


REFUSED = {
    "sequential": (["--scenario_name", "nav_metered_one_goal_graph_sequential"], "A7"),
    "fairassign": (["--scenario_name", "nav_fairassign_fairrew_formation_graph_rotate_tube"],
                   "A7"),
    # a directory of the reference's actor.pt weights (made by the test)
    "warm_start_actor_pt": (["--warm_start_dir", "{actor_pt}"], "A11"),
    "mpe": (["--env_name", "MPE", "--scenario_name", "simple_spread"], "A9"),
    # trunk shapes the kernels are not built for (the CPU's plain trunk
    # would run them, the card's first launch would not), on either route
    "trunk_width": (["--gnn_hidden_size", "32"], "A6.3"),
    "trunk_depth": (["--gnn_layer_N", "8"], "A6.3"),
    "trunk_width_dense": (["--gnn_hidden_size", "32", "--gnn_impl", "dense"], "A6.3"),
    # more graph entities than the kernels take (E = 40 > 32)
    "entities": (["--num_agents", "20", "--num_landmarks", "20"], "A6.3"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_name_their_roadmap_item(name, tmp_path, tmp_path_factory):
    argv, item = REFUSED[name]
    if argv and "{actor_pt}" in argv:
        src = tmp_path_factory.mktemp("reference_weights")
        (src / "actor.pt").write_bytes(b"")
        argv = [str(src) if a == "{actor_pt}" else a for a in argv]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        cli_train.main(FLOAT32 + argv + ["--cuda", "--run_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir()), "a refused run writes nothing"


SMALL = FLOAT32 + ["--cuda", "--num_agents", "3", "--n_rollout_threads", "8", "--episode_length", "5",
         "--ppo_epoch", "2", "--log_interval", "1", "--use_eval", "--eval_episodes", "4",
         "--seed", "3"]


def _state_tensors(ts):
    """Every tensor and number of a TrainState, by name."""
    out = {}
    for side in ("actor", "critic"):
        for k, v in getattr(ts.params, side).state_dict().items():
            out[f"{side}.{k}"] = v
        opt = getattr(ts, f"{side}_opt").state_dict()
        for i, st in opt["state"].items():
            for k, v in st.items():
                out[f"{side}_opt.{i}.{k}"] = v
        for j, g in enumerate(opt["param_groups"]):
            out[f"{side}_opt.group{j}.lr"] = g["lr"]
    if ts.vn is not None:
        for f in dataclasses.fields(ts.vn):
            out[f"vn.{f.name}"] = getattr(ts.vn, f.name)
    return out


def test_cli_runs_saves_restores_and_resumes_on_cpu(tmp_path):
    run_dir, ts = cli_train.main(SMALL + ["--num_env_steps", str(2 * 8 * 5),
                                          "--run_dir", str(tmp_path)])
    models = os.path.join(run_dir, "models")
    assert sorted(os.listdir(models)) == ["ckpt_0", "ckpt_1", "config.json", "latest.json"]
    with open(os.path.join(models, "latest.json")) as f:
        assert json.load(f)["episode"] == 1
    assert _resolve_ckpt_path(models).endswith("ckpt_1")
    assert load_run_config(models)["n_rollout_threads"] == 8
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [40, 40, 80]  # episode 0, its eval, episode 1
    assert "value_loss" in records[0] and "eval_success_rate" in records[1]
    assert all(v == v for r in records for v in r.values())

    # the restore round trip, bit for bit, into a state drawn from another seed
    args = flags.parse_all(SMALL)
    _, _, trainer, _ = cli_train.build(args, "cpu")
    restored, episode = restore_checkpoint(models, trainer.init_state(99))
    assert episode == 1 and isinstance(restored.vn, (ValueNormState, PopArtState))
    want, got = _state_tensors(ts), _state_tensors(restored)
    assert set(got) == set(want) and len(want) > 40
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k

    # resume: restarts at the saved episode 1, as the JAX CLI does, and goes
    # on to episode 2
    run_dir2, ts2 = cli_train.main(SMALL + ["--num_env_steps", str(3 * 8 * 5), "--run_dir",
                                            str(tmp_path), "--model_dir", models])
    assert run_dir2 == run_dir
    with open(os.path.join(models, "latest.json")) as f:
        assert json.load(f)["episode"] == 2
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [40, 40, 80, 80, 120]
    assert not torch.equal(ts2.params.actor.action_out.weight, want["actor.action_out.weight"])


def test_cli_trains_and_evaluates_v4oct_double_integrator_on_cpu(tmp_path):
    """Two tiny v4oct episodes with the double integrator through the train
    CLI, then the eval CLI on the checkpoint it wrote."""
    dyn = ["--scenario_name", V4OCT, "--dynamics_type", "double_integrator"]
    run_dir, ts = cli_train.main(SMALL + dyn + ["--num_env_steps", str(2 * 8 * 5),
                                                "--run_dir", str(tmp_path / "train")])
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [40, 40, 80]
    assert all(v == v and abs(v) != float("inf") for r in records for v in r.values())
    models = os.path.join(run_dir, "models")
    run_cfg = load_run_config(models)
    assert (run_cfg["scenario_name"], run_cfg["dynamics_type"]) == (V4OCT, "double_integrator")
    assert ts.params.actor.action_out.weight.shape[0] == 5  # the 5-action table
    rows = cli_eval.main(["--model_dir", models, "--scenario_name", V4OCT, "--num_agents", "3",
                          "--episode_length", "5", "--render_episodes", "2", "--cuda",
                          "--run_dir", str(tmp_path / "eval")])
    assert len(rows) == 2 and all(v == v for r in rows for v in r.values())


def test_cli_trains_restores_and_evaluates_obstacles_on_cpu(tmp_path):
    """BASELINE config 2's env (5 agents, 5 landmarks, 3 obstacles: E = 13)
    through the train CLI, its checkpoint restored bit for bit, then the
    eval CLI on it, which reads the obstacle collisions."""
    env = ["--num_agents", "5", "--num_landmarks", "5", "--num_obstacles", "3"]
    argv = SMALL[:SMALL.index("--num_agents")] + SMALL[SMALL.index("--num_agents") + 2:] + env
    run_dir, ts = cli_train.main(argv + ["--num_env_steps", str(2 * 8 * 5),
                                         "--run_dir", str(tmp_path / "train")])
    models = os.path.join(run_dir, "models")
    assert load_run_config(models)["num_obstacles"] == 3
    _, _, trainer, _ = cli_train.build(flags.parse_all(argv), "cpu")
    restored, episode = restore_checkpoint(models, trainer.init_state(99))
    want, got = _state_tensors(ts), _state_tensors(restored)
    assert episode == 1 and set(got) == set(want)
    for k, v in want.items():
        assert (torch.equal(got[k], v) and got[k].dtype == v.dtype
                if isinstance(v, torch.Tensor) else got[k] == v), k
    # Ds = 8 node features - the type + its 2-wide embedding = 9
    assert ts.params.actor.gnn_base.embed_layer.lin1.weight.shape[1] == 9
    rows = cli_eval.main(["--model_dir", models, "--cuda", "--render_episodes", "2",
                          "--episode_length", "5", "--run_dir", str(tmp_path / "eval")] + env)
    assert len(rows) == 2 and all(v == v for r in rows for v in r.values())


def test_cli_trains_in_bfloat16_by_default_on_cpu(tmp_path):
    """The JAX CLI's default command line, with no --compute_dtype: two tiny
    episodes whose MLP tails compute in bfloat16 (the parameters stay
    float32), the checkpoint restored bit for bit and warm-started from,
    then the eval CLI on it, which evaluates in float32 as the JAX
    package's does."""
    argv = SMALL[len(FLOAT32):]
    assert "--compute_dtype" not in argv
    run_dir, ts = cli_train.main(argv + ["--num_env_steps", str(2 * 8 * 5),
                                         "--run_dir", str(tmp_path / "train")])
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [40, 40, 80]
    assert all(v == v and abs(v) != float("inf") for r in records for v in r.values())
    models = os.path.join(run_dir, "models")
    assert load_run_config(models)["compute_dtype"] == "bfloat16"
    _, policy, trainer, _ = cli_train.build(flags.parse_all(argv), "cpu")
    assert policy.cfg.compute_dtype == "bfloat16"
    restored, episode = restore_checkpoint(models, trainer.init_state(99))
    want, got = _state_tensors(ts), _state_tensors(restored)
    assert episode == 1 and set(got) == set(want)
    for k, v in want.items():
        assert (torch.equal(got[k], v) and got[k].dtype == v.dtype
                if isinstance(v, torch.Tensor) else got[k] == v), k
    assert all(p.dtype == torch.float32 for p in ts.params.actor.parameters())
    feats = ts.params.critic.base(torch.randn(4, ts.params.critic.cfg.gnn_hidden_size))
    assert feats.dtype == torch.bfloat16
    # a warm start from it takes its weights bit for bit and trains on
    env_params = cli_train.build(flags.parse_all(argv), "cpu")[0]
    warm = warm_start_params(models, trainer.init_state(7), env_params.obs_dim)
    for side in ("actor", "critic"):
        for k, v in getattr(ts.params, side).state_dict().items():
            assert torch.equal(getattr(warm.params, side).state_dict()[k], v), (side, k)
    _, ts_warm = cli_train.main(argv + ["--num_env_steps", str(8 * 5), "--warm_start_dir",
                                        models, "--run_dir", str(tmp_path / "warm")])
    assert all(torch.isfinite(p).all() for p in ts_warm.params.actor.parameters())
    rows = cli_eval.main(["--model_dir", models, "--cuda", "--render_episodes", "2",
                          "--num_agents", "3", "--episode_length", "5",
                          "--run_dir", str(tmp_path / "eval")])
    assert len(rows) == 2 and all(v == v for r in rows for v in r.values())


@pytest.mark.parametrize("kind", ["hj", "exp_cbf"])
def test_cli_trains_and_evaluates_with_the_safety_filter_on_cpu(kind, tmp_path, capsys,
                                                                 monkeypatch):
    """Two tiny filtered episodes through the train CLI (the air taxi's HJ
    filter on the synthetic table, as the JAX CLI falls back to it where the
    reference's pickle is missing, and the double integrator's exponential
    CBF), the checkpoint restored bit for bit, then the eval CLI on it,
    which takes the run's filter from its config.json."""
    argv = SMALL + ["--use_safety_filter", "True", "--safety_filter_type", kind]
    if kind == "exp_cbf":
        argv += ["--dynamics_type", "double_integrator"]
    run_dir, ts = cli_train.main(argv + ["--num_env_steps", str(2 * 8 * 5),
                                         "--run_dir", str(tmp_path / "train")])
    synthetic = "not found; using the synthetic HJ table"
    assert (synthetic in capsys.readouterr().out) == (kind == "hj")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [40, 40, 80]
    assert all(v == v and abs(v) != float("inf") for r in records for v in r.values())
    models = os.path.join(run_dir, "models")
    run_cfg = load_run_config(models)
    assert (run_cfg["use_safety_filter"], run_cfg["safety_filter_type"]) == (True, kind)
    _, _, trainer, runner = cli_train.build(flags.parse_all(argv), "cpu")
    assert (runner.hj_data is not None) == (kind == "hj")
    if kind == "hj":
        assert runner.hj_data.values.dtype == torch.float32
    restored, episode = restore_checkpoint(models, trainer.init_state(99))
    want, got = _state_tensors(ts), _state_tensors(restored)
    assert episode == 1 and set(got) == set(want)
    for k, v in want.items():
        assert (torch.equal(got[k], v) and got[k].dtype == v.dtype
                if isinstance(v, torch.Tensor) else got[k] == v), k
    filtered = []
    real_step = tenv.step

    def recording_step(*a, **k):
        st, step_ts = real_step(*a, **k)
        filtered.append(int(st.safety_violations.sum()))
        return st, step_ts

    monkeypatch.setattr(tenv, "step", recording_step)
    rows = cli_eval.main(["--model_dir", models, "--cuda", "--render_episodes", "2",
                          "--num_agents", "3", "--episode_length", "5",
                          "--run_dir", str(tmp_path / "eval")])
    assert len(rows) == 2 and all(v == v for r in rows for v in r.values())
    assert filtered and sum(filtered) > 0, "the evaluation filters"


# the curriculum across ten episodes, with the fairness bump at half of them
CURRICULUM = ["--use_curriculum", "True", "--increase_fairness", "True", "--collision_rew",
              "5", "--formation_rew", "2", "--num_agents", "2", "--num_landmarks", "2",
              "--n_rollout_threads", "1", "--episode_length", "2", "--ppo_epoch", "1",
              "--num_env_steps", "20", "--use_wandb", "--seed", "4"]


def test_curriculum_schedule_matches_jax(tmp_path, monkeypatch):
    """The rewards of every build and of every checkpoint's config, through
    ten episodes of both packages' train CLI with the curriculum and the
    fairness bump (stages 1-9, the bump at episode 5 before that episode's
    stage).  The JAX CLI runs with its ``build`` and episode step stubbed in
    this test (nothing compiles); the port trains for real on the CPU."""
    rews = lambda a: (a.collision_rew, a.formation_rew, a.fair_rew)
    jbuilds, jsaves, tbuilds, tsaves = [], [], [], []

    class Stub:
        def init_state(self, key):
            return {}

        def init_carry(self, key):
            return jnp.zeros(())

        def train_episode(self, ts, carry, key):
            return ts, carry, {}, {}

    def stub_build(args):
        jbuilds.append(rews(args))
        return None, Stub(), Stub(), Stub()

    monkeypatch.setattr(jcli_train, "build", stub_build)
    monkeypatch.setattr(jcheckpoint, "save_checkpoint", lambda d, ts, ep, config: jsaves.append(
        (ep, config["collision_rew"], config["formation_rew"], config["fair_rew"])))
    jcli_train.main(CURRICULUM + ["--run_dir", str(tmp_path / "jax")])

    real_build_env, real_save = flags.build_env_params, tcheckpoint.save_checkpoint

    def recording_build_env(args):
        tbuilds.append(rews(args))
        return real_build_env(args)

    def recording_save(save_dir, ts, episode, config=None):
        tsaves.append((episode, config["collision_rew"], config["formation_rew"],
                       config["fair_rew"]))
        return real_save(save_dir, ts, episode, config=config)

    monkeypatch.setattr(flags, "build_env_params", recording_build_env)
    monkeypatch.setattr(tcheckpoint, "save_checkpoint", recording_save)
    run_dir, _ = cli_train.main(FLOAT32 + CURRICULUM + ["--cuda", "--run_dir",
                                                        str(tmp_path / "port")])
    assert tbuilds == jbuilds and tsaves == jsaves
    assert len(jbuilds) == 11  # the first build, stages 1-9 and the bump
    assert jsaves[0] == (0, 0.5, 0.2, 0.1) and jsaves[-1][0] == 9
    # the bump at episode 5 rebases the curriculum on the stage-4 rewards
    assert jsaves[5] == (5, 1.0, 0.4, 5.0)
    cfg = load_run_config(os.path.join(run_dir, "models"))
    assert (cfg["collision_rew"], cfg["formation_rew"], cfg["fair_rew"]) == jsaves[-1][1:]


def test_centralized_v_off_with_cent_obs_is_refused(tmp_path):
    """``--use_centralized_V`` (off) with ``--use_cent_obs True`` feeds the
    critic an observation narrower than the layers built for the shared
    one: the JAX package's critic stops on the shape at its first call, and
    the port refuses the run, naming both widths, before it writes
    anything."""
    argv = ["--use_centralized_V", "--use_cent_obs", "True", "--num_agents", "3"]
    with pytest.raises(ValueError, match=r"width is 19 .* cent_obs_dim 57"):
        cli_train.main(FLOAT32 + argv + ["--cuda", "--run_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir()), "a refused run writes nothing"
    # the JAX side: the critic of the built policy, called as its runner
    # calls it with the centralized V off (each agent's own observation)
    jargs = jflags.parse_all(FLOAT32 + argv)
    jenv_params, jpolicy, jtrainer, jrunner = jcli_train.build(jargs)
    assert jrunner.use_centralized_v is False and jpolicy.dims.cent_obs_dim == 57
    # traced for shapes only (jax.eval_shape): the shape check is flax's
    ts = jax.eval_shape(jtrainer.init_state, jax.random.PRNGKey(0))
    n, E, F = 3, jenv_params.num_entities, jenv_params.node_feat_dim
    values = lambda p: jpolicy.get_values(
        p, jnp.zeros((n, 19)), jnp.zeros((n, E, F)), jnp.ones((n, E, E)),
        jnp.zeros((n, n), jnp.int32),
        jnp.zeros((n, jpolicy.cfg.recurrent_n, jpolicy.cfg.hidden_size)), jnp.ones((n, 1)))
    with pytest.raises(flax.errors.ScopeParamShapeError, match=r"\(35,\).*\(73,\)"):
        jax.eval_shape(values, ts.params)


def test_critic_node_aggregation_is_refused(tmp_path):
    """``--critic_graph_aggr node``: the runner gives the critic every
    agent's id (the JAX runner's ``share_agent_id``, (B*N, N) rows), which
    the 'node' gather cannot take.  The JAX package's first collect stops on
    it with a ``TypeError`` (its train CLI after writing the run's
    metrics.jsonl); the port refuses the run with a ``ValueError`` that
    names the reason, before it writes anything."""
    argv = ["--critic_graph_aggr", "node", "--num_agents", "3"]
    with pytest.raises(ValueError, match=r"critic_graph_aggr='node'.*N agent ids a row"):
        cli_train.main(FLOAT32 + argv + ["--cuda", "--run_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir()), "a refused run writes nothing"
    # the JAX side: the built policy's get_actions, called as its runner's
    # collect calls it (traced for shapes only, jax.eval_shape)
    jargs = jflags.parse_all(FLOAT32 + argv)
    jenv_params, jpolicy, jtrainer, _ = jcli_train.build(jargs)
    assert jpolicy.cfg.critic_graph_aggr == "node" and not jpolicy._transposed_routable()
    ts = jax.eval_shape(jtrainer.init_state, jax.random.PRNGKey(0))
    n, E, F = 3, jenv_params.num_entities, jenv_params.node_feat_dim
    h = jnp.zeros((n, jpolicy.cfg.recurrent_n, jpolicy.cfg.hidden_size))
    aid = jnp.arange(n, dtype=jnp.int32).reshape(n, 1)
    share_aid = jnp.broadcast_to(aid.reshape(1, n), (n, n))
    collect = lambda p: jpolicy.get_actions(
        p, jax.random.PRNGKey(1), jnp.zeros((n, 57)), jnp.zeros((n, 19)), jnp.zeros((n, E, F)),
        jnp.ones((n, E, E)), aid, share_aid, h, h, jnp.ones((n, 1)))
    with pytest.raises(TypeError, match=r"cannot reshape array of shape \(3,\)"):
        jax.eval_shape(collect, ts.params)


def test_cli_trains_restores_and_evaluates_concat_heads_on_cpu(tmp_path):
    """``--gnn_concat_heads`` at the CLI's default bfloat16: two tiny
    episodes through the dense GNN (lin_skip and the extra conv layers 48
    wide), the checkpoint restored bit for bit, then the eval CLI, which
    rebuilds the same route from the run's config.json."""
    argv = SMALL[len(FLOAT32):] + ["--gnn_concat_heads"]
    calls = []
    real = gnn_trunk.gnn_trunk_forward
    gnn_trunk.gnn_trunk_forward = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        run_dir, ts = cli_train.main(argv + ["--num_env_steps", str(2 * 8 * 5),
                                             "--run_dir", str(tmp_path / "train")])
        models = os.path.join(run_dir, "models")
        assert load_run_config(models)["gnn_concat_heads"] is True
        _, policy, trainer, _ = cli_train.build(flags.parse_all(argv), "cpu")
        assert policy.cfg.compute_dtype == "bfloat16" and not policy.cfg.kernel_trunk
        restored, episode = restore_checkpoint(models, trainer.init_state(99))
        want, got = _state_tensors(ts), _state_tensors(restored)
        assert episode == 1 and set(got) == set(want)
        for k, v in want.items():
            assert (torch.equal(got[k], v) and got[k].dtype == v.dtype
                    if isinstance(v, torch.Tensor) else got[k] == v), k
        gnn = ts.params.critic.gnn_base
        assert tuple(gnn.gnn1.lin_skip.weight.shape) == (48, 16)
        assert tuple(gnn.gnn2_0.lin_query.weight.shape) == (48, 48)
        assert ts.params.actor.base.feature_norm.weight.shape[0] == 19 + 48
        rows = cli_eval.main(["--model_dir", models, "--cuda", "--render_episodes", "2",
                              "--num_agents", "3", "--episode_length", "5",
                              "--run_dir", str(tmp_path / "eval")])
    finally:
        gnn_trunk.gnn_trunk_forward = real
    assert len(rows) == 2 and all(v == v for r in rows for v in r.values())
    assert not calls, "the dense route never calls the trunk"


def test_cli_trains_restores_and_evaluates_packed_fused_on_cpu(tmp_path):
    """``--gnn_impl dense --gnn_edge_packed True --fuse_gnn_trunks True`` at
    the CLI's default bfloat16: two tiny episodes whose updates run both
    GNNs in one pass (``gnn_dense_nodes_dual``) in the packed layout
    (``embed_conv_packed``), the checkpoint restored bit for bit, then the
    eval CLI, which rebuilds the packed layout from the run's config.json;
    no trunk call."""
    from contracts_marl_aam_corridors_tpu_torch.models import nets

    argv = SMALL[len(FLOAT32):] + ["--gnn_impl", "dense", "--gnn_edge_packed", "True",
                                   "--fuse_gnn_trunks", "True"]
    calls = {"trunk": 0, "dual_nodes": 0, "packed": 0}
    real = (gnn_trunk.gnn_trunk_forward, nets.gnn_dense_nodes_dual, nets.embed_conv_packed)

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    gnn_trunk.gnn_trunk_forward = counting("trunk", real[0])
    nets.gnn_dense_nodes_dual = counting("dual_nodes", real[1])
    nets.embed_conv_packed = counting("packed", real[2])
    try:
        run_dir, ts = cli_train.main(argv + ["--num_env_steps", str(2 * 8 * 5),
                                             "--run_dir", str(tmp_path / "train")])
        trained = dict(calls)
        models = os.path.join(run_dir, "models")
        run_cfg = load_run_config(models)
        assert run_cfg["gnn_edge_packed"] is True and run_cfg["fuse_gnn_trunks"] is True
        _, policy, trainer, _ = cli_train.build(flags.parse_all(argv), "cpu")
        assert policy.cfg.compute_dtype == "bfloat16" and policy.cfg.gnn_edge_packed
        assert policy.fuse_gnn_trunks and policy._fused_routable()
        restored, episode = restore_checkpoint(models, trainer.init_state(99))
        want, got = _state_tensors(ts), _state_tensors(restored)
        assert episode == 1 and set(got) == set(want)
        for k, v in want.items():
            assert (torch.equal(got[k], v) and got[k].dtype == v.dtype
                    if isinstance(v, torch.Tensor) else got[k] == v), k
        packed_before = calls["packed"]
        rows = cli_eval.main(["--model_dir", models, "--cuda", "--render_episodes", "2",
                              "--num_agents", "3", "--episode_length", "5",
                              "--run_dir", str(tmp_path / "eval")])
    finally:
        gnn_trunk.gnn_trunk_forward, nets.gnn_dense_nodes_dual, nets.embed_conv_packed = real
    assert len(rows) == 2 and all(v == v for r in rows for v in r.values())
    # 2 ppo epochs an episode, each one fused pass (its packed EmbedConv
    # mapped once over both sides); the collects' and the eval's calls
    # each run the packed EmbedConv of one network
    assert trained["dual_nodes"] == 4 and trained["trunk"] == 0
    assert trained["packed"] > 4 and calls["packed"] > packed_before
    assert calls["trunk"] == 0, "the dense route never calls the trunk"


# the shipped july checkpoint in the port's layout and its JAX original
JULY = os.path.join(ROOT, "model_weights_torch", "july", "unicycle")
JULY_ORBAX = os.path.join(ROOT, "model_weights", "july", "unicycle")
# eval_stats.csv's columns, as the JAX package's cli/eval.py:96-107 names them
JAX_EVAL_COLUMNS = ["episode", "ep_rew", "success_frac", "time_mean", "time_stddev",
                    "dist_mean", "dist_stddev", "agent_collisions", "conformance",
                    "spacing_violations"]
EVAL_ARGV = ["--model_dir", JULY, "--num_agents", "3"]


def test_eval_cli_short_run_writes_jax_columns(tmp_path):
    gnn_trunk.gnn_trunk_forward.launches = 0
    rows = cli_eval.main(EVAL_ARGV + ["--episode_length", "10", "--render_episodes", "1",
                                      "--cuda", "--run_dir", str(tmp_path)])
    with open(tmp_path / cli_eval.CSV, newline="") as f:
        written = list(csv.DictReader(f))
    assert list(written[0]) == JAX_EVAL_COLUMNS and len(written) == len(rows) == 1
    assert 0.0 <= rows[0]["success_frac"] <= 1.0
    assert all(v == v for v in rows[0].values())
    assert gnn_trunk.gnn_trunk_forward.launches == 0  # the CPU runs the plain trunk


def test_merge_eval_args_matches_jax():
    """The trained run's flags over an eval command line, as the JAX package
    merges its config.yaml: the run's activation flags and recipe win, the
    command line keeps the env shape, the seed and the run directory."""
    argv = ["--num_agents", "3", "--episode_length", "150", "--render_episodes", "2",
            "--seed", "7", "--run_dir", "elsewhere"]
    got = merge_eval_args(flags.parse_all(argv), load_run_config(JULY))
    want = jcheckpoint.merge_eval_args(jflags.parse_all(argv),
                                       jcheckpoint.load_run_config(JULY_ORBAX))
    assert vars(got) == vars(want)
    assert (got.use_ReLU, got.embed_use_ReLU, got.gnn_use_ReLU) == (False, True, True)
    assert (got.dynamics_type, got.world_size, got.seed, got.run_dir) == (
        "unicycle_vehicle", 4.0, 7, "elsewhere")


EVAL_REFUSED = {
    "mpe": (["--env_name", "MPE", "--scenario_name", "simple_spread"], None, "A9"),
    "reference_actor_pt": ([], "actor.pt", "A11"),
    "gifs": (["--use_render", "--save_gifs"], None, "A11"),
}


@pytest.mark.parametrize("name", sorted(EVAL_REFUSED))
def test_eval_refusals_name_their_roadmap_item(name, tmp_path):
    argv, file, item = EVAL_REFUSED[name]
    model_dir = tmp_path / "weights"
    model_dir.mkdir()
    if file:
        (model_dir / file).write_bytes(b"")
    run_dir = tmp_path / "run"
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        cli_eval.main(argv + ["--model_dir", str(model_dir), "--cuda", "--run_dir",
                              str(run_dir)])
    assert not run_dir.exists(), "a refused evaluation writes nothing"


def test_eval_cli_defaults_to_the_card(tmp_path):
    """Without ``--cuda`` the evaluation asks for the card, though the
    trained run's config.json records ``cuda: true`` either way."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card; the default device is valid here")
    assert load_run_config(JULY)["cuda"] is True
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_eval.main(EVAL_ARGV + ["--episode_length", "2", "--render_episodes", "1",
                                   "--run_dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()


def test_resolve_ckpt_path_layouts(tmp_path):
    """latest.json with a path relative to its directory or absolute, one
    ckpt_<N> directory, or the highest ckpt_<N> directory of a models
    directory, whatever else lies there."""
    for n in (2, 10):
        (tmp_path / f"ckpt_{n}").mkdir()
    (tmp_path / "ckpt_notes.txt").write_text("")
    (tmp_path / "ckpt_best").mkdir()
    assert _resolve_ckpt_path(str(tmp_path)) == str(tmp_path / "ckpt_10")
    assert _resolve_ckpt_path(str(tmp_path / "ckpt_2")) == str(tmp_path / "ckpt_2")
    for path in ("ckpt_2", str(tmp_path / "ckpt_2")):
        (tmp_path / "latest.json").write_text(json.dumps({"episode": 2, "path": path}))
        assert _resolve_ckpt_path(str(tmp_path)) == str(tmp_path / "ckpt_2")
