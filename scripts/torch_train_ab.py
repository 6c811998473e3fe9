"""Flagship training episodes and PPO update epochs of the torch port on
the card, for comparing two trees of the repository on one card.

    python scripts/torch_train_ab.py --root <repo root> [--compute_dtype bfloat16]

Imports the port from ``--root``, builds its kernels, and runs the flagship
episode of ``chip_smoke.py``'s train phase, with the envs, steps, PPO
epochs, chunk length and seeds read from the ``chip_smoke.py`` beside this
script's directory, whichever tree ``--root`` names (july air_taxi, one
minibatch, random weights): one warm-up episode, then five timed ones (host
clock around work that ends in a synchronize); then a 2-epoch update on one
collected buffer, timed three times and profiled once.  Prints one JSON line: the
episode seconds, the update's wall ms an epoch, and its device ms and
kernels an epoch, in all and in the trunk backward kernel.  To compare a
change with its parent, unpack ``git archive HEAD`` into a directory that
``.gitignore`` lists and run parent, change, change, parent in one command;
to compare the compute dtypes, run float32, bfloat16, bfloat16, float32 on
one root.
"""
import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path


def flagship():
    """``chip_smoke.py``'s module, for its train phase's settings."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=".")
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    a = p.parse_args()
    cs = flagship()
    sys.path.insert(0, a.root)
    import torch
    from contracts_marl_aam_corridors_tpu_torch.config.physics import vehicle_config
    from contracts_marl_aam_corridors_tpu_torch.envs.types import EnvParams
    from contracts_marl_aam_corridors_tpu_torch.learner import GRMAPPOTrainer, Runner
    from contracts_marl_aam_corridors_tpu_torch.models import (
        GRMAPPOPolicy, ModelConfig, PolicyDims,
    )
    from contracts_marl_aam_corridors_tpu_torch.ops import gnn_trunk

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gnn_trunk.build_all()
    ep = EnvParams(cfg=vehicle_config("air_taxi"))
    # a tree from before bfloat16 compute takes no compute_dtype
    dtype = {} if a.compute_dtype == "float32" else {"compute_dtype": a.compute_dtype}
    cfg = ModelConfig(max_edge_dist=ep.cfg.coordination_range, **dtype)
    dims = PolicyDims(ep.obs_dim, ep.obs_dim * ep.num_agents, ep.num_entities,
                      ep.node_feat_dim, ep.num_actions)
    policy = GRMAPPOPolicy(cfg, dims)
    trainer = GRMAPPOTrainer(policy, ppo_epoch=cs.PPO_EPOCH, num_mini_batch=1,
                             data_chunk_length=cs.CHUNK)
    ts = trainer.init_state(cs.SEED)
    runner = Runner(env_params=ep, policy=policy, trainer=trainer,
                    n_rollout_threads=cs.TRAIN_ENVS, episode_length=cs.STEPS)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 6)
    carry = runner.init_carry(cs.SEED + 6)
    ts, carry, _, _ = runner.train_episode(ts, carry, gen)  # warm-up
    torch.cuda.synchronize()
    eps = []
    for _ in range(5):
        t0 = time.perf_counter()
        ts, carry, _, _ = runner.train_episode(ts, carry, gen)
        torch.cuda.synchronize()
        eps.append(time.perf_counter() - t0)

    # a 2-epoch update on one buffer: wall ms an epoch, then device ms
    pt = GRMAPPOTrainer(policy, ppo_epoch=2, data_chunk_length=cs.CHUNK)
    carry, buf, _ = runner.collect(ts, carry)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        pt.train(ts, buf)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 500)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pt.train(ts, buf)
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in evts) / 2e3
    bwd_ms = sum(e.self_device_time_total for e in evts if "gnn_trunk_bwd" in e.key) / 2e3
    print(json.dumps({"root": a.root, "compute_dtype": a.compute_dtype, "episode_s": eps,
                      "episode_median_s": statistics.median(eps), "epoch_wall_ms": walls,
                      "epoch_device_ms": dev_ms, "epoch_bwd_ms": bwd_ms,
                      "epoch_kernels": sum(e.count for e in evts) / 2}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
