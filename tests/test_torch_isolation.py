"""The torch port stands alone: it loads nothing of JAX or of the JAX
package, and its entry points run on the card unless told otherwise."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from contracts_marl_aam_corridors_tpu_torch.config.physics import vehicle_config
from contracts_marl_aam_corridors_tpu_torch.envs import env as env_mod
from contracts_marl_aam_corridors_tpu_torch.envs.types import EnvParams
from contracts_marl_aam_corridors_tpu_torch.learner import GRMAPPOTrainer, Runner
from contracts_marl_aam_corridors_tpu_torch.models import GRMAPPOPolicy, ModelConfig, PolicyDims

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
import contracts_marl_aam_corridors_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "contracts_marl_aam_corridors_tpu")
)
print(json.dumps({"names": names, "bad": bad}))
"""

# modules each slice added, which the probe must have walked
MODULES = (
    "cli.train", "config.flags", "utils.checkpoint", "utils.logging", "ops.gnn_trunk",
    "models.nets", "tools.relu_flips", "tools.forward_f64", "ops.gnn_trunk_v2", "cli.eval",
    "tools.eval_batched",
)


def test_port_and_chip_smoke_load_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    probe = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(probe["names"]) >= 25, probe["names"]
    assert probe["bad"] == [], probe["bad"]
    for m in MODULES:
        assert f"contracts_marl_aam_corridors_tpu_torch.{m}" in probe["names"], m


def _dims(ep):
    return PolicyDims(ep.obs_dim, ep.obs_dim * ep.num_agents, ep.num_entities,
                      ep.node_feat_dim, ep.num_actions)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a card; the default device is valid here")
    ep = EnvParams(cfg=vehicle_config("air_taxi"))
    cfg = ModelConfig(max_edge_dist=ep.cfg.coordination_range)
    with pytest.raises(RuntimeError, match="CUDA"):
        GRMAPPOPolicy(cfg, _dims(ep))
    with pytest.raises(RuntimeError, match="CUDA"):
        env_mod.reset(ep, 2, torch.Generator())
    cpu_policy = GRMAPPOPolicy(cfg, _dims(ep), device="cpu")
    trainer = GRMAPPOTrainer(cpu_policy)
    with pytest.raises(RuntimeError, match="CUDA"):
        Runner(env_params=ep, policy=cpu_policy, trainer=trainer, n_rollout_threads=2,
               episode_length=2)
    # asked for explicitly, the CPU works
    Runner(env_params=ep, policy=cpu_policy, trainer=trainer, n_rollout_threads=2,
           episode_length=2, device="cpu")


def test_train_cli_defaults_to_the_card(tmp_path):
    """The train entry point asks for the card unless ``--cuda`` (the
    reference's store_false flag) asks for the CPU; it writes nothing before
    it has its device."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card; the default device is valid here")
    from contracts_marl_aam_corridors_tpu_torch.cli import train as cli_train
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_train.main(["--num_agents", "3", "--n_rollout_threads", "2", "--episode_length",
                        "2", "--num_env_steps", "4", "--compute_dtype", "float32",
                        "--run_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
