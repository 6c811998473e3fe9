#!/usr/bin/env python3
"""Drive the torch port's july rollout, evaluation, PPO training, train
CLI and eval CLI, the shipped checkpoints of the july and the exit-gated
scenarios, and a warm-started gated training run on one CUDA card.

    python3 chip_smoke.py

Builds the port's kernels (``csrc/gnn_trunk_fwd.cu``, ``gnn_trunk_bwd.cu``,
``gnn_trunk_dual_fwd.cu``, ``gnn_trunk_dual_bwd.cu`` and
``gnn_forward_v2.cu``, one ``nvcc`` each for sm_90a, in parallel), holds
each against its plain torch version on the card (and the v2 forward also
against the trunk forward kernel, bit for bit), runs ``Runner.collect`` at
4096 envs x 25 steps, ``Runner.eval_episode`` at 1024 envs, ``Runner.train_episode`` at
1024 envs x 25 steps with 15 PPO epochs, both trunks through
``nets.gnn_transposed_apply_dual`` at the update's shape, ``make_gnn_forward_v2``,
the train CLI (``cli.train.main``, three flagship episodes, a checkpoint
restore and a resume), the shipped checkpoints (``model_weights_torch/``:
july, rot_inv, three_phase, three_phase at 10 agents, and the two 5-agent
two_phase ones) under the JAX package's batched evaluation, each held to
its JAX numbers (``jax_eval*.json``), the eval CLI (``cli.eval.main``) on
the july one, and the train CLI on three_phase warm-started from the
rot_inv checkpoint, all at the models' full width, and checks that every
GNN trunk forward and backward of those paths went through the kernels.
The forward and backward kernels are also held at the gated graphs' width
(7 node features, Ds = 8; july's give 9), and at the graphs of obstacles
and walls (E = 13, Ds = 9 and E = 22, Ds = 14), which the train and eval
CLIs then run end to end (BASELINE config 2, and 10 agents with 2 walls).
The circle and line landmark formations run whole episodes from the numpy
parity reset on the card against the CPU and train and evaluate through
the CLIs, and the JAX CLI's default command line (bfloat16 compute) trains
at the flagship shape.  The safety filters (the air taxi's HJ filter on the
synthetic table, the double integrator's exponential CBF, ORCA) run their
envs on the card against the CPU with every choice of the filters compared,
and the flagship with HJ and BASELINE config 4 with the exponential CBF
train and evaluate through the CLIs, as does the flagship with the
curriculum and the critic on each agent's own observation.  The dense
per-graph GNN (plain torch) is held on the card against the CPU's float64
and, at averaged heads, against the kernel trunk, and the flagship with
``--gnn_impl dense`` and with ``--gnn_concat_heads`` (bfloat16) and
BASELINE config 2 with the actor's global max pool train and evaluate
through the CLIs without launching a trunk kernel.  The dense route's packed
edge layout (``--gnn_edge_packed``) is held on the card against the CPU's
float64 and bfloat16 and against the dense layout, its fused trunks
(``--fuse_gnn_trunks``) against the unfused update with both updates
profiled, the kernel route with both flags launches rows 1 and 2 as without
them, and the flagship trains and evaluates packed and fused in bfloat16.
Prints one JSON line per phase (device, build, kernel, backward, dual, v2,
rollout, eval, train, cli, checkpoint (one for each evaluation), eval_cli,
gated_train, env_card, rk45_card, v4oct_train, v4oct_eval, walls_env_card,
walls_trunk, obstacles_train, obstacles_eval, walls_train, walls_eval,
formations_env_card, formations_train and formations_eval (one for each
formation), bf16_train, bf16_eval, safety_env_card, safety_train and
safety_eval (one for each filter), safety_unfiltered_beside, a12_train,
a12_eval, dense_card, dense_train, dense_eval, concat_train, concat_eval,
aggr_train, aggr_eval, packed_card, fused_kernel_route_train,
fused_kernel_route_eval, fused_card, packed_train, packed_eval, kernels), then
the card's name and power limit as
``nvidia-smi`` gives them, then ``{"ok": true, "device": {...}}`` as the
last line.  Any failed check raises,
so the script exits non-zero without that line.  Without a CUDA device, or
without the port's package beside it, it exits non-zero and prints no
result.  It imports nothing of JAX.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = "contracts_marl_aam_corridors_tpu_torch"

N_ENVS, STEPS, EVAL_ENVS = 4096, 25, 1024
# the flagship training episode: 1024 envs x 25 steps x 3 agents = 76,800
# graphs per trunk call of the update, 15 epochs of one minibatch
TRAIN_ENVS, PPO_EPOCH, CHUNK = 1024, 15, 10
TRAIN_EPISODES = 3
CLI_EPISODES = 3  # then the last one again, resumed from its checkpoint
CMP_ENVS = 64  # the card-vs-CPU update
SEED = 0
# Kernel vs plain version.  Both compute in float32 with sums in different
# orders.  At the rollout's 12288 graphs the float32 plain version itself
# lies up to 1.7e-6 (random graphs) and 3.3e-6 (env-reset graphs) from a
# float64 evaluation of the same function (this script's plain_vs_f64 on an
# H100), so two float32 orders differ by up to twice that at outputs near
# zero, beyond an atol of 1e-6.  Every case is therefore held at rtol 1e-5
# with an atol of 1e-5, and the kernel must also be no further from the
# float64 evaluation than twice the plain version is (kernel_vs_f64).
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
# E = 20 sums over 20 sources per target and layer: the trunk bar of the JAX
# package (tests/test_models.py:529).  There the float64 criterion compares
# relative L2 errors, not the largest error: the largest of 655,360 errors
# is one element's, and its kernel-to-plain ratio spreads widely from draw
# to draw while the L2 ratio stays near 1 (tools/forward_f64.py).
WIDE_TOL = dict(rtol=2e-4, atol=2e-5)
NET_TOL = dict(rtol=2e-4, atol=2e-5)
# Backward kernels vs plain backward, per leaf (each parameter, dsrc, dadj):
# the JAX package's gradient bar |k - p| <= 1e-4 max|p| + 1e-5
# (tests/test_models.py:611-613); where the float32 plain version is itself
# further than that from a float64 evaluation, the kernel must be no further
# from the float64 evaluation than twice the plain version is.  With relu a
# relu input within float32 rounding of zero may take the other sign in the
# kernel's order of the sums than in the plain version's, and that one
# subgradient flip moves its graph's gradient by tens of percent and every
# parameter leaf by some 1e-4 (at 76,800 random graphs it happens in a
# graph or two).  So with relu the graphs where a relu input of either trunk
# lies within float32 rounding of zero (tools/relu_flips.py
# near_zero_graphs) are set aside: their cotangent is zeroed, so they add
# nothing to any leaf, and the other graphs are held at the bar.  The single
# backward's relu case also prints the comparison with every graph kept
# (all_graphs_kept): what the set-aside takes out.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# Card vs CPU update: losses and norms at rtol 1e-4.  The first epoch's
# policy loss is minus the mean normalized advantage, zero up to rounding, so
# an atol of 1e-6 stands beside the rtol.
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6
# H100 SXM published peaks (NVIDIA data sheet, dense): FP32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# the shipped july checkpoint in the port's layout, with the JAX package's
# evaluation of it (scripts/orbax_to_torch.py), and the protocol of that
# evaluation (scripts/_eval_common.py run_side): 4 x 256 episodes
JULY_CKPT = Path("model_weights_torch") / "july" / "unicycle"
EVAL_SEEDS, EVAL_BATCH = 4, 256
# The port's means against the JAX package's over those episodes.  The two
# frameworks draw different resets from the same seeds, so the bar is
# statistical: at success 0.98 over 3,072 agent-episodes a side's mean has a
# standard deviation of about 0.0025 (all-agents success 0.95 over 1,024
# episodes: 0.0068), so a bar of 0.02 (0.04) is some five standard
# deviations of the difference.  Collisions an episode: the JAX package's
# four seed means (jax_eval.json) spread with a standard deviation of
# 0.065, so a 4-seed mean has about 0.033 and the difference of the two
# sides about 0.046; the bar of 0.23 is five of those.
EVAL_BARS = {"success_rate": 0.02, "all_success_rate": 0.04, "gate_success_rate": 0.02,
             "num_agent_collisions": 0.23}
# The shipped gated checkpoints, converted the same way, with the JAX
# package's evaluations of them: (label, directory, JAX file, metrics held).
# rot_inv and three_phase are held on distance-to-goal success; the
# two_phase checkpoints on gate success, since their distance-based success
# reads 0 by design (scripts/two_phase_eval.py:4-7).  three_phase is also
# evaluated at 10 agents and 10 landmarks (E = 20, jax_eval_10a.json).
WEIGHTS = Path("model_weights_torch")
DIST_HELD = ("success_rate", "all_success_rate", "num_agent_collisions")
GATE_HELD = ("gate_success_rate", "all_gate_success_rate", "num_agent_collisions")
GATED_EVALS = [
    ("rot_inv", WEIGHTS / "rot_inv" / "airtaxi", "jax_eval.json", DIST_HELD),
    ("three_phase", WEIGHTS / "three_phase" / "airtaxi", "jax_eval.json", DIST_HELD),
    ("three_phase_10a", WEIGHTS / "three_phase" / "airtaxi", "jax_eval_10a.json", DIST_HELD),
    ("two_phase_5a", WEIGHTS / "two_phase_5a" / "airtaxi", "jax_eval.json", GATE_HELD),
    ("two_phase_5a_low_collision", WEIGHTS / "two_phase_5a" / "airtaxi_low_collision",
     "jax_eval.json", GATE_HELD),
]
# the gated graphs' node features (7, so Ds = 8 where july's 8 give 9) and
# the gated training phase's update batch: 64 envs x 75 steps x 3 agents
GATED_NODE_FEAT = 7
GATED_TRAIN_ENVS, GATED_STEPS, GATED_EPISODES = 64, 75, 2
# the three_phase recipe's flags the gated training phase takes from its
# config.json (config.yaml's), besides --use_popart
GATED_RECIPE_KEYS = ("scenario_name", "dynamics_type", "num_agents", "num_landmarks",
                     "episode_length", "n_rollout_threads", "total_actions", "ppo_epoch",
                     "num_mini_batch", "data_chunk_length", "collision_rew", "goal_rew",
                     "formation_rew", "fair_rew", "world_size", "lr", "critic_lr",
                     "entropy_coef", "seed")
# The env of the double integrator and v4oct on the card against the CPU:
# these (scenario, vehicle) pairs at 256 envs in float64 through one
# episode of the reference launcher's double integrator (25 steps,
# metered_formation_rotate.sh:87-116), whose last step auto-resets every
# env; the env's float64 parity bar (tests/test_golden_parity.py:143-161).
# rk45 at 4,096 states of each vehicle.
ENV_CARD_PAIRS = [("v4oct", "air_taxi"), ("v4oct", "double_integrator"),
                  ("rotate_tube_july", "double_integrator"), ("rot_inv", "double_integrator")]
ENV_CARD_ENVS, ENV_CARD_STEPS, ENV_TOL = 256, 25, 1e-9
RK45_STATES = 4096
# the train CLI on v4oct with the double integrator, at the flagship's
# envs, epochs and chunks and the launcher's 25-step episode
V4OCT = "nav_metered_one_goal_graph_rotate_tube_v4oct"
V4OCT_EPISODES = 2
# Obstacles and walls.  BASELINE config 2 (BASELINE.json:8): july, air_taxi,
# 5 agents, 5 landmarks, 3 obstacles (E = 13, 8 node features: Ds = 9),
# world 4, at the flagship's 1024 envs x 25 steps, 15 epochs: 128,000
# graphs an update trunk call.  10 agents, 10 landmarks and 2 walls with the
# double integrator (BASELINE config 4 without its safety filter; E = 22,
# the 13-dim wall rows: Ds = 14), world 4, at 256 envs (the flagship's 1024
# cut): 64,000 graphs an update trunk call.  Their env on the card against
# the CPU at the env_card protocol, with july and the double integrator's
# single wall (E = 7), v4oct with 2 obstacles and 2 walls (E = 10) and
# rot_inv with 3 obstacles.
OBST_ENV = dict(num_agents=5, num_landmarks=5, num_obstacles=3, world_size=4.0)
WALL_ENV = dict(num_agents=10, num_landmarks=10, num_walls=2, world_size=4.0)
WALL_ENVS = 256
WALLS_EPISODES = 2
# their card-vs-CPU updates, about the graphs' work of the flagship's 64
# envs (the CPU's plain trunk takes most of the time): 2,000 graphs of E =
# 13 and 1,000 of E = 22
OBST_CMP_ENVS, WALL_CMP_ENVS = 16, 4
F64_CHUNK = 16000  # graphs of a float64 plain backward at a time
WALLS_ENV_CARD = [
    ("rotate_tube_july", "air_taxi", OBST_ENV),
    ("rotate_tube_july", "double_integrator", dict(num_walls=1)),
    ("v4oct", "air_taxi", dict(num_obstacles=2, num_walls=2)),
    ("rot_inv", "air_taxi", dict(num_obstacles=3, world_size=4.0, collision_rew=30.0,
                                 goal_rew=20.0, formation_rew=5.0)),
]
# The circle and line formations: whole episodes card against CPU in
# float64, ENV_CARD_ENVS envs each from its own numpy parity reset
# (np.random.seed(k)), with the fixed freeze heading, FORMATION_STEPS steps
# and no re-sync at a freeze (v4oct's goal branch is unreachable: it never
# freezes); july with circle trains at the flagship shape, v4oct with line
# and the double integrator at v4oct_train's.
FORMATION_ENV_CARD = [("rotate_tube_july", "unicycle_vehicle", "circle"),
                      ("v4oct", "air_taxi", "line"),
                      ("rotate_tube_july", "double_integrator", "line")]
FORMATION_STEPS = 150
FIXED_THETA = 0.7
FORMATION_PLACED = 8  # envs that start an agent beside its goal
FORMATION_CMP_ENVS = 16  # their card-vs-CPU updates
# bfloat16 compute: the JAX CLI's default command line at the flagship
# shape; one update's first-epoch gradients card against CPU at 16 envs,
# at the bars of tests/test_torch_bf16.py with the CPU's bfloat16 in the JAX
# package's place: the card's distance from the CPU's float32 gradient
# within BF16_RATIO x the CPU's bfloat16 distance + BF16_GRAD_ATOL x the
# leaf's largest entry + GRAD_ATOL, the JAX gradient bar's floor, which
# holds a leaf whose gradient is zero but for rounding, such as a key bias
# (the loss: + BF16_ATOL)
BF16_CMP_ENVS = 16
BF16_RATIO, BF16_ATOL, BF16_GRAD_ATOL = 2.0, 2e-3, 2e-3
# The safety filters.  Their envs card against CPU at env_card's protocol
# (ENV_CARD_ENVS envs, ENV_CARD_STEPS steps, float64, ENV_TOL): july with
# air_taxi and HJ on the synthetic table with every safety reward term on;
# BASELINE config 4 (BASELINE.json:10: 10 agents, 10 landmarks, 2 walls,
# the double integrator, world 4; E = 22) with the exponential CBF and with
# ORCA; rot_inv with HJ.  A discrete choice of a filter (the neighbour, the
# HJ branch, the coordination range, the filtered flag, a bound, ORCA's
# most-violated constraint) that differs between the devices is counted
# with its gap, the distance of the deciding quantity from the other
# choice: a last-bit difference can flip one only within FLIP_GAP_BAR of a
# tie, so a flip beyond it fails.  The env goes on from the CPU's state.
SAFETY_ENV_CARD = [
    ("july hj toggles", "air_taxi", dict(use_safety_filter=True, safety_filter_type="hj",
                                         reward_toggles="all")),
    ("config 4 exp_cbf", "double_integrator", dict(WALL_ENV, use_safety_filter=True,
                                                   safety_filter_type="exp_cbf")),
    ("config 4 rvo", "double_integrator", dict(WALL_ENV, use_safety_filter=True,
                                               safety_filter_type="rvo")),
    ("rot_inv hj", "air_taxi", dict(scenario="rot_inv", use_safety_filter=True,
                                    safety_filter_type="hj")),
]
FLIP_GAP_BAR = 1e-9
# the filtered trainings' card-vs-CPU update (the flagship's; config 4's is
# WALL_CMP_ENVS)
SAFETY_CMP_ENVS = 16
# The dense per-graph GNN (plain torch; --gnn_impl dense, --gnn_concat_heads,
# --actor_graph_aggr global).  dense_card: (E, node features, graphs,
# gradients) at the flagship update's 76,800 graphs of E = 6, BASELINE
# config 2's E = 13 at 3,072 graphs and the walls' E = 22 (13 node features)
# at 2,560, forward only (its (B, E, E, 16) message tensor under autograd at
# an update's size would take several GB); the CPU's float32 and float64
# forwards on the first DENSE_CPU_GRAPHS graphs of each.  The card's
# float32 error from the CPU's float64 at most DENSE_F64_RATIO x the CPU
# float32's + DENSE_F64_ATOL.  The dense trainings' card-vs-CPU or
# dense-vs-kernel updates take DENSE_CMP_ENVS envs.
DENSE_CARD_SHAPES = [(6, 8, 76_800, True), (13, 8, 3_072, True), (22, 13, 2_560, False)]
DENSE_CPU_GRAPHS = 8_192
DENSE_F64_RATIO, DENSE_F64_ATOL = 2.0, 1e-6
DENSE_AGGRS = ("node", "mean", "max", "add")
DENSE_CMP_ENVS = 16
# The dense route's layout flags.  packed_card: the packed edge layout
# (--gnn_edge_packed) at (E, node features, graphs): the flagship update's
# 76,800 graphs of E = 6 and config 2's E = 13 at 3,072, tanh, on weights
# drawn away from their init; the CPU's float32, float64 and bfloat16 on the
# first PACKED_CPU_GRAPHS graphs; packed against the dense layout on the
# card at the JAX package's packed-vs-dense forward bar
# (tests/test_packed_gnn.py:46-48).  fused_card: the fused update
# (--fuse_gnn_trunks) against the unfused one at that file's bars (:136-147).
PACKED_CARD_SHAPES = [(6, 8, 76_800), (13, 8, 3_072)]
PACKED_CPU_GRAPHS = 2_048
PACKED_FWD_TOL = dict(rtol=1e-5, atol=1e-5)
FUSED_TOL = dict(rtol=1e-5, atol=1e-5)
FUSED_GRAD_TOL = dict(rtol=5e-4, atol=1e-5)
# eval_stats.csv's columns, as the JAX package's cli/eval.py writes them
JAX_EVAL_COLUMNS = ["episode", "ep_rew", "success_frac", "time_mean", "time_stddev",
                    "dist_mean", "dist_stddev", "agent_collisions", "conformance",
                    "spacing_violations"]


def checkpoint_bars(jax_ref: dict, held, agents: int) -> dict:
    """The bars of a gated checkpoint's evaluation against the JAX package's
    (fixed in CHANGES.md before its first card run): five standard
    deviations of the difference of the two sides' 4-seed means.  A rate's
    one-side deviation is binomial at the JAX mean over the agent-episodes
    (per agent) or the episodes (all agents) of the protocol, and the bar is
    never tighter than the july bars, 0.02 and 0.04.  Collisions an episode:
    the JAX package's four seed means spread with a sample standard
    deviation s, so a 4-seed mean has s / 2."""
    episodes = EVAL_SEEDS * EVAL_BATCH
    bars = {}
    for k in held:
        if k == "num_agent_collisions":
            side = statistics.stdev(r[k] for r in jax_ref["rows"]) / EVAL_SEEDS ** 0.5
            bars[k] = 5 * 2 ** 0.5 * side
        else:
            p, n = jax_ref["mean"][k], episodes if k.startswith("all_") else episodes * agents
            floor = 0.04 if k.startswith("all_") else 0.02
            bars[k] = max(floor, 5 * 2 ** 0.5 * (p * (1 - p) / n) ** 0.5)
    return bars


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# Cycles of torch.cuda._sleep (about 1 ms on the H100) that keep the card
# busy while the host submits a timed kernel launch.
BUSY_CYCLES = 2_000_000

# Seconds of host pause at each end of a profiled window whose launch counts
# are checked.  At moments seconds apart the profiler puts a kernel's device
# time, on the host's clock, before the kernel's host launch, and a window opened
# just before the launch then comes back with no device event; a host pause
# before the launch keeps it (scripts/profile_window_probe.py measures both).
PROFILE_PAUSE_S = 0.02


def time_ms(torch, fn, reps=30, warmup=3, hide_host=False) -> float:
    """Median over ``reps`` of one call's time, from CUDA events: with
    ``hide_host`` the device's alone (the card is kept busy while the host
    submits the call, as it is when launches queue up), else the call's on
    an idle card, the host's submission included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        if hide_host:
            torch.cuda._sleep(BUSY_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(work) -> tuple[float, str]:
    """The least time the card could take for ``work`` (operations at the
    FP32 peak, bytes at the HBM rate), in ms, and which of the two bounds
    it."""
    ops_ms = work["flops"] / PEAK_FP32_FLOPS * 1e3
    bytes_ms = work["bytes"] / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def forward_vs_f64(k, p, x, wide: bool) -> tuple[dict, bool]:
    """How far a forward kernel's output ``k`` and the float32 plain
    version's ``p`` lie from the float64 evaluation ``x``, and whether the
    kernel is no further than twice the plain version: by the largest error,
    or at E = 20 (``wide``) by the relative L2 error."""
    ek, ep = k.double() - x, p.double() - x
    row = {"kernel_vs_f64": ek.abs().max().item(), "plain_vs_f64": ep.abs().max().item(),
           "kernel_vs_f64_rel_l2": (ek.norm() / x.norm()).item(),
           "plain_vs_f64_rel_l2": (ep.norm() / x.norm()).item()}
    key = "_rel_l2" if wide else ""
    return row, row[f"kernel_vs_f64{key}"] <= 2 * row[f"plain_vs_f64{key}"]


def compare_leaves(got, want, exact) -> list[dict]:
    """Per leaf (each parameter, dsrc, dadj), kernel vs float32 plain vs
    float64 plain: the gradient bar of GRAD_RTOL and GRAD_ATOL, or, where
    the plain version misses it against float64, the kernel within twice the
    plain version's distance from float64."""
    rows = []
    for k, p, x in zip(got, want, exact):
        k, p, x = k.double(), p.double(), x.double()
        err = (k - p).abs().max().item()
        bar = GRAD_RTOL * p.abs().max().item() + GRAD_ATOL
        k64, p64 = (k - x).abs().max().item(), (p - x).abs().max().item()
        ok = err <= bar or (p64 > bar and k64 <= 2 * p64)
        rows.append({"max_abs_err": err, "bar": bar, "kernel_vs_f64": k64,
                     "plain_vs_f64": p64, "ok": ok})
    return rows


def train_state_tensors(ts) -> dict:
    """Every tensor and number of a TrainState (both networks, both Adam
    states, the value normalizer), by name."""
    out = {}
    for side in ("actor", "critic"):
        for k, v in getattr(ts.params, side).state_dict().items():
            out[f"{side}.{k}"] = v
        opt = getattr(ts, f"{side}_opt").state_dict()
        for i, st in opt["state"].items():
            for k, v in st.items():
                out[f"{side}_opt.{i}.{k}"] = v
        for j, group in enumerate(opt["param_groups"]):
            out[f"{side}_opt.group{j}.lr"] = group["lr"]
    if ts.vn is not None:
        for f in dataclasses.fields(ts.vn):
            out[f"vn.{f.name}"] = getattr(ts.vn, f.name)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / PACKAGE).is_dir():
        print(f"chip_smoke: {PACKAGE}/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from contracts_marl_aam_corridors_tpu_torch.config.physics import vehicle_config
    from contracts_marl_aam_corridors_tpu_torch.envs import env as env_mod
    from contracts_marl_aam_corridors_tpu_torch.envs.types import EnvParams, map_state
    from contracts_marl_aam_corridors_tpu_torch.learner import (
        GRMAPPOTrainer, Runner, TrainState, vn_init, vn_update,
    )
    from contracts_marl_aam_corridors_tpu_torch.models import (
        GRMAPPOPolicy, ModelConfig, PolicyDims, nets,
    )
    from contracts_marl_aam_corridors_tpu_torch.ops import gnn_trunk, gnn_trunk_v2
    from contracts_marl_aam_corridors_tpu_torch.tools import relu_flips

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- device
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---------------------------------------------------------------- build
    t_build = time.perf_counter()
    built = gnn_trunk.build_all()
    emit({"phase": "build", "wall_seconds": time.perf_counter() - t_build, "kernels": {
        name: {"nvcc_seconds": b["seconds"], "library": Path(b["library"]).name,
               "ptxas": b["ptxas"]} for name, b in built.items()}})

    # the model, at the default widths of the july configuration
    ep = EnvParams(cfg=vehicle_config("air_taxi"))
    cfg = ModelConfig(max_edge_dist=ep.cfg.coordination_range)
    dims = PolicyDims(ep.obs_dim, ep.obs_dim * ep.num_agents, ep.num_entities,
                      ep.node_feat_dim, ep.num_actions)
    policy = GRMAPPOPolicy(cfg, dims)
    params = policy.init_params(SEED)
    ts = TrainState(params=params, vn=vn_init(torch.float32, dev))
    rollout_trainer = GRMAPPOTrainer(policy)

    # ---------------------------------------------------------------- kernel
    def trunk_args(c, E, Ds):
        return (E, Ds, c.gnn_num_heads, c.gnn_hidden_size, c.embed_layer_n,
                c.gnn_layer_n, c.max_edge_dist, (c.embed_use_relu, c.gnn_use_relu))

    def transposed(gnn, node_obs, adj):
        B, E, _ = node_obs.shape
        src_T = nets._gnn_src_T(gnn, node_obs)
        adj_T = adj.permute(1, 2, 0).reshape(E * E, B).contiguous()
        return src_T, adj_T

    def random_graphs(B, E, max_edge, gen, F=8):
        node = torch.randn((B, E, F), generator=gen, device=dev)
        node[..., -1] = torch.randint(0, 2, (B, E), generator=gen, device=dev).float()
        a = torch.rand((B, E, E), generator=gen, device=dev) * 2 * max_edge
        adj = (a + a.transpose(1, 2)) / 2
        adj[:, torch.arange(E), torch.arange(E)] = 0.0
        return node, adj

    def rollout_graphs():
        g = torch.Generator(device=dev).manual_seed(SEED)
        _, t0 = env_mod.reset(ep, N_ENVS, g, dev)
        B, N, E = N_ENVS, ep.num_agents, ep.num_entities
        node = t0.node_obs.reshape(B * N, E, -1)
        adj = t0.adj[:, None].expand(B, N, E, E).reshape(B * N, E, E)
        return node, adj

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases = []
    with torch.no_grad():
        B_roll = N_ENVS * ep.num_agents
        rand_node, rand_adj = random_graphs(B_roll, ep.num_entities, cfg.max_edge_dist, gen)
        cases.append(("rollout launch batch, random graphs, relu", params.actor.gnn_base, cfg,
                      rand_node, rand_adj, KERNEL_TOL))
        node, adj = rollout_graphs()
        cases.append(("rollout launch batch, env reset graphs, relu", params.actor.gnn_base,
                      cfg, node, adj, KERNEL_TOL))
        ragged_node, ragged_adj = random_graphs(3109, ep.num_entities, cfg.max_edge_dist, gen)
        cases.append(("ragged B, relu", params.actor.gnn_base, cfg, ragged_node, ragged_adj,
                      KERNEL_TOL))
        tcfg = ModelConfig(max_edge_dist=cfg.max_edge_dist, embed_use_relu=False,
                           gnn_use_relu=False)
        tanh_gnn = nets.GNNBase(tcfg, ep.node_feat_dim, "node").to(dev)
        tanh_gnn.load_state_dict(params.critic.gnn_base.state_dict())
        cases.append(("ragged B, tanh", tanh_gnn, tcfg, ragged_node, ragged_adj, KERNEL_TOL))
        edgeless = ragged_adj.clone()
        edgeless[::7] = 0.0  # no edges at all
        edgeless[1::7] = 2 * cfg.max_edge_dist  # every edge beyond range
        cases.append(("edgeless graphs", params.actor.gnn_base, cfg, ragged_node, edgeless,
                      KERNEL_TOL))
        wide_gnn = nets.GNNBase(cfg, 8, "node")
        wide_gnn.init_(torch.Generator().manual_seed(SEED + 2))
        wide_gnn = wide_gnn.to(dev)
        wide_node, wide_adj = random_graphs(2048, 20, cfg.max_edge_dist, gen)
        cases.append(("E=20", wide_gnn, cfg, wide_node, wide_adj, WIDE_TOL))
        B_UPD = TRAIN_ENVS * STEPS * ep.num_agents  # graphs per trunk call of the update
        upd_node, upd_adj = random_graphs(B_UPD, ep.num_entities, cfg.max_edge_dist, gen)
        cases.append(("update batch, relu", params.actor.gnn_base, cfg, upd_node, upd_adj,
                      KERNEL_TOL))
        # its own generator, so the draws of the other cases stay as they were
        e10k_node, e10k_adj = random_graphs(4096, 10, cfg.max_edge_dist,
                                            torch.Generator(device=dev).manual_seed(SEED + 9))
        cases.append(("E=10, relu", wide_gnn, cfg, e10k_node, e10k_adj, KERNEL_TOL))
        # the gated scenarios' graphs: 7 node features, so Ds = 8 where every
        # case above has july's Ds = 9; tanh in the embedding and the GNN, as
        # the shipped gated checkpoints; weights of seed 0 of a gated-width
        # GNNBase; E = 6 at the gated training update's 14,400 graphs, E = 10
        # at the 5-agent two_phase evaluation's 1,280, E = 20 at the 10-agent
        # three_phase evaluation's 2,560 (their own generator)
        gcfg = ModelConfig(max_edge_dist=cfg.max_edge_dist, embed_use_relu=False,
                           gnn_use_relu=False)
        gated_gnn = nets.GNNBase(gcfg, GATED_NODE_FEAT, "node")
        gated_gnn.init_(torch.Generator().manual_seed(SEED))
        gated_gnn = gated_gnn.to(dev)
        ggen = torch.Generator(device=dev).manual_seed(SEED + 10)
        gated_graphs = {
            E: random_graphs(B, E, cfg.max_edge_dist, ggen, GATED_NODE_FEAT)
            for E, B in ((6, GATED_TRAIN_ENVS * GATED_STEPS * 3), (10, EVAL_BATCH * 5),
                         (20, EVAL_BATCH * 10))}
        for E, (nd, ad) in gated_graphs.items():
            cases.append((f"gated E={E}, tanh, Ds=8", gated_gnn, gcfg, nd, ad,
                          WIDE_TOL if E == 20 else KERNEL_TOL))

        def forward_plan(c, E, Ds, B):
            """The forward kernel's plan for B graphs and what the card makes
            of it (threads, registers, local memory, CTAs an SM)."""
            dims = (E, Ds, c.gnn_num_heads, c.embed_hidden_size, c.gnn_hidden_size,
                    c.embed_layer_n, c.gnn_layer_n, B)
            return {**gnn_trunk.kernel_config(*dims), **gnn_trunk.forward_attributes(*dims)}

        checks, max_err = [], 0.0
        for name, gnn, c, nd, ad, tol in cases:
            src_T, adj_T = transposed(gnn, nd, ad)
            E, B = nd.shape[1], nd.shape[0]
            args = trunk_args(c, E, src_T.shape[0] // E)
            flat = nets._flatten_gnn_params(gnn, c.embed_layer_n, c.gnn_layer_n)
            got = gnn_trunk.gnn_trunk_forward(*args, gnn.kernel_params(), src_T, adj_T)
            # a second launch on the same inputs gives the same bits
            identical = torch.equal(
                got, gnn_trunk.gnn_trunk_forward(*args, gnn.kernel_params(), src_T, adj_T))
            want = gnn_trunk.gnn_trunk_forward_plain(*args, flat, src_T, adj_T)
            exact = gnn_trunk.gnn_trunk_forward_plain(*args, flat, src_T, adj_T,
                                                      compute_dtype=torch.float64)
            prefix = None
            if B == B_UPD:
                # no graph's result depends on its tile or on the threads a
                # row is split over: the first 768, 1,536 and 3,072 graphs
                # alone (small tiles, rows split over 8, 4 and 2 threads)
                # equal them inside the full launch (the full plan), bit for
                # bit
                prefix = []
                for n in (768, 1536, 3072):
                    pre = gnn_trunk.gnn_trunk_forward(*args, gnn.kernel_params(),
                                                      src_T[:, :n].contiguous(),
                                                      adj_T[:, :n].contiguous())
                    plan = forward_plan(c, E, args[1], n)
                    prefix.append({"graphs": n, "equal": torch.equal(pre, got[:, :n]),
                                   "graphs_per_cta": plan["graphs_per_cta"],
                                   "threads_per_row": plan["threads_per_row"]})
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            f64, f64_ok = forward_vs_f64(got, want, exact, tol is WIDE_TOL)
            conf = forward_plan(c, E, args[1], B)
            ok = (bool(torch.isfinite(got).all()) and torch.allclose(got, want, **tol)
                  and f64_ok and identical and all(r["equal"] for r in prefix or ())
                  and conf["ctas_per_sm"] >= conf["planned_ctas_per_sm"])
            checks.append({"case": name, "E": E, "Ds": args[1], "B": B, "max_abs_err": err,
                           **tol, **f64, "two_launches_identical": identical,
                           "prefix_alone": prefix, "ok": ok, **conf})
            if not ok:
                emit({"phase": "kernel", "checks": checks})
                raise AssertionError(f"kernel disagrees with the plain version: {name}")
            max_err = max(max_err, err)
            if name.startswith("gated"):
                # the gated shapes' device ms beside their bound and the plain version's
                kp_g, o = gnn.kernel_params(), torch.empty_like(got)
                edges = int(((adj_T > 0) & (adj_T < c.max_edge_dist)).sum().item())
                w = gnn_trunk.trunk_work(E, args[1], args[2], kp_g.F1, args[3], c.embed_layer_n,
                                         c.gnn_layer_n, B, edges, kp_g.blob.numel())
                b_ms, b_by = bound(w)
                checks[-1].update(
                    ms=time_ms(torch, lambda: gnn_trunk.launch_kernel(
                        *args, kp_g, src_T, adj_T, o), hide_host=True),
                    plain_ms=time_ms(torch, lambda: gnn_trunk.gnn_trunk_forward_plain(
                        *args, flat, src_T, adj_T), reps=5, warmup=1),
                    bound_ms=b_ms, bound_by=b_by, edges=edges)

        # timing at the rollout's launch shape (4096 envs x 3 agents, E = 6)
        gnn = params.actor.gnn_base
        src_T, adj_T = transposed(gnn, node, adj)
        E = ep.num_entities
        args = trunk_args(cfg, E, src_T.shape[0] // E)
        flat = nets._flatten_gnn_params(gnn, cfg.embed_layer_n, cfg.gnn_layer_n)
        kp = gnn.kernel_params()
        if not torch.equal(kp.blob, gnn_trunk.param_blob(
                flat, cfg.embed_layer_n, cfg.gnn_layer_n).blob):
            raise AssertionError("GNNBase.kernel_params differs from param_blob of the flat params")
        out = torch.empty((E * cfg.gnn_hidden_size, src_T.shape[1]), device=dev)
        kernel_ms = time_ms(torch, lambda: gnn_trunk.launch_kernel(
            *args, kp, src_T, adj_T, out), hide_host=True)
        # the wrapper as the model calls it: checks, output allocation, launch
        wrapper_ms = time_ms(torch, lambda: gnn_trunk.gnn_trunk_forward(
            *args, gnn.kernel_params(), src_T, adj_T))
        plain_ms = time_ms(torch, lambda: gnn_trunk.gnn_trunk_forward_plain(
            *args, flat, src_T, adj_T))
        n_edges = int(((adj_T > 0) & (adj_T < cfg.max_edge_dist)).sum().item())
        work = gnn_trunk.trunk_work(E, args[1], args[2], kp.F1, args[3], cfg.embed_layer_n,
                                    cfg.gnn_layer_n, src_T.shape[1], n_edges, kp.blob.numel())

        # the launch sizes of the paths: the checkpoint evaluation's 768
        # graphs (256 envs x 3 agents), the eval phase's 3,072, the
        # rollout's 12,288 and the update's 76,800, each with its plan
        sizes = []
        for nd, ad in ((upd_node[:768], upd_adj[:768]), (upd_node[:3072], upd_adj[:3072]),
                       (node, adj), (upd_node, upd_adj)):
            s_T, a_T = transposed(gnn, nd, ad)
            B = nd.shape[0]
            o = torch.empty((E * cfg.gnn_hidden_size, B), device=dev)
            reps = 30 if B < B_UPD else 10

            def launch(s_T=s_T, a_T=a_T, o=o):
                gnn_trunk.launch_kernel(*args, kp, s_T, a_T, o)

            # the device's time, and a call's on an idle card (the host's
            # submission included, as in the evaluation's serial launches)
            ms = time_ms(torch, launch, reps=reps, hide_host=True)
            call_ms = time_ms(torch, launch, reps=reps)
            p_ms = time_ms(torch, lambda: gnn_trunk.gnn_trunk_forward_plain(
                *args, flat, s_T, a_T), reps=5, warmup=1)
            edges = int(((a_T > 0) & (a_T < cfg.max_edge_dist)).sum().item())
            w = gnn_trunk.trunk_work(E, args[1], args[2], kp.F1, args[3], cfg.embed_layer_n,
                                     cfg.gnn_layer_n, B, edges, kp.blob.numel())
            b_ms, b_by = bound(w)
            sizes.append({"B": B, "ms": ms, "call_ms": call_ms, "plain_ms": p_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "edges": edges, **w,
                          **forward_plan(cfg, E, args[1], B)})
    bound_ms, bound_by = bound(work)
    timing = {"B": src_T.shape[1], "E": E, "ms": kernel_ms, "wrapper_ms": wrapper_ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
              "flops": work["flops"], "bytes": work["bytes"], "edges": n_edges,
              "library_ms": None}
    fwd_plans_ok = all(r["ctas_per_sm"] >= r["planned_ctas_per_sm"] for r in sizes)
    emit({"phase": "kernel", "kernel": "gnn_trunk_fwd", "checks": checks, **timing,
          "sizes": sizes, "ptxas": built["gnn_trunk_fwd"]["ptxas"]})
    if not fwd_plans_ok:
        raise AssertionError("the forward kernel's plan counts more CTAs an SM than the card holds")

    # ---------------------------------------------------------------- backward
    def grad_leaves(c, Ds, dblob, dsrc, dadj):
        flat = gnn_trunk.unpack_blob(gnn_trunk.KernelParams(dblob, c.embed_hidden_size), Ds,
                                     c.gnn_num_heads, c.gnn_hidden_size, c.embed_layer_n,
                                     c.gnn_layer_n)
        return list(flat) + [dsrc, dadj]

    def set_aside_relu_flips(c, args, trunks, adj_T, gs):
        """With relu, zero the cotangents ``gs`` of every graph where a relu
        input of one of the ``trunks`` ((flat params, src) pairs) lies within
        float32 rounding of zero, and return those graphs' mask; with tanh,
        an empty one."""
        near = torch.zeros(adj_T.shape[-1], dtype=torch.bool, device=adj_T.device)
        if not (c.embed_use_relu or c.gnn_use_relu):
            return near
        for flat, src_T in trunks:
            near |= relu_flips.near_zero_graphs(args, flat, src_T, adj_T)
        for g in gs:
            g[:, near] = 0.0
        return near

    def all_graphs_kept(c, Ds, args, kp, flat, src_T, adj_T, g, aside):
        """The single backward held to the plain version with no graph set
        aside: the largest leaf error over its bar, and the graphs whose dsrc
        departs from the plain version's by more than 1e-3 of its largest
        entry, with how many of them ``aside`` holds.  Printed, not held:
        it shows what the set-aside takes out."""
        got = grad_leaves(c, Ds, *gnn_trunk.gnn_trunk_backward(*args, kp, src_T, adj_T, g))
        dflat, ds, da = gnn_trunk.gnn_trunk_backward_plain(*args, flat, src_T, adj_T, g)
        want = list(dflat) + [ds, da]
        ratio = max((k - p).abs().max().item()
                    / (GRAD_RTOL * p.abs().max().item() + GRAD_ATOL) for k, p in zip(got, want))
        off = (got[-2] - want[-2]).abs().amax(0) > 1e-3 * want[-2].abs().amax(0)
        return {"worst_ratio_to_bar": ratio, "graphs_dsrc_off_plain": int(off.sum().item()),
                "of_them_set_aside": int((off & aside).sum().item())}

    bwd_checks, bwd_max_err = [], 0.0
    with torch.no_grad():
        wide_tanh = nets.GNNBase(tcfg, 8, "node")
        wide_tanh.init_(torch.Generator().manual_seed(SEED + 2))
        wide_tanh = wide_tanh.to(dev)
        # its own generator, so the draws of the other cases stay as they were
        mid_node, mid_adj = random_graphs(2048, 10, cfg.max_edge_dist,
                                          torch.Generator(device=dev).manual_seed(SEED + 8))
        bwd_cases = [
            ("update batch, tanh", tanh_gnn, tcfg, upd_node, upd_adj),
            ("update batch, relu", params.actor.gnn_base, cfg, upd_node, upd_adj),
            ("ragged B, tanh", tanh_gnn, tcfg, ragged_node, ragged_adj),
            ("edgeless graphs, tanh", tanh_gnn, tcfg, ragged_node, edgeless),
            ("E=10, tanh", wide_tanh, tcfg, mid_node, mid_adj),
            ("E=20, tanh", wide_tanh, tcfg, wide_node, wide_adj),
            ("gated E=6, tanh, Ds=8", gated_gnn, gcfg, *gated_graphs[6]),
            ("gated E=10, tanh, Ds=8", gated_gnn, gcfg, *gated_graphs[10]),
        ]
        for name, gnn, c, nd, ad in bwd_cases:
            src_T, adj_T = transposed(gnn, nd, ad)
            E, B = nd.shape[1], nd.shape[0]
            Ds = src_T.shape[0] // E
            args = trunk_args(c, E, Ds)
            g = torch.randn((E * c.gnn_hidden_size, B), generator=gen, device=dev)
            kp = gnn.kernel_params()
            flat = gnn_trunk.unpack_blob(kp, Ds, c.gnn_num_heads, c.gnn_hidden_size,
                                         c.embed_layer_n, c.gnn_layer_n)
            g_all = g.clone()
            aside = set_aside_relu_flips(c, args, [(flat, src_T)], adj_T, [g])
            kept = (all_graphs_kept(c, Ds, args, kp, flat, src_T, adj_T, g_all, aside)
                    if aside.any() else None)
            del g_all
            first = gnn_trunk.gnn_trunk_backward(*args, kp, src_T, adj_T, g)
            # a second launch on the same inputs: the sums run in a fixed order
            identical = all(torch.equal(a, b) for a, b in zip(
                first, gnn_trunk.gnn_trunk_backward(*args, kp, src_T, adj_T, g)))
            got = grad_leaves(c, Ds, *first)
            dflat, ds, da = gnn_trunk.gnn_trunk_backward_plain(*args, flat, src_T, adj_T, g)
            want = list(dflat) + [ds, da]
            dflat, ds, da = gnn_trunk.gnn_trunk_backward_plain(
                *args, flat, src_T, adj_T, g, compute_dtype=torch.float64)
            exact = list(dflat) + [ds, da]
            torch.cuda.synchronize()
            finite = all(bool(torch.isfinite(t).all()) for t in got)
            rows = compare_leaves(got, want, exact)
            # graphs whose dsrc lies further than 1e-3 of its largest entry
            # from float64 (where a relu input flipped, that one graph's
            # gradient jumps), and the other graphs' distance
            size = exact[-2].abs().amax(0)
            off = lambda a: (a.double() - exact[-2]).abs().amax(0) > 1e-3 * size
            keep = ~off(want[-2])
            graphs_off_f64 = {
                "kernel": int(off(got[-2]).sum().item()), "plain": int((~keep).sum().item()),
                "plain_dsrc_rel_l2_other_graphs": ((want[-2].double() - exact[-2])[:, keep].norm()
                                                   / exact[-2][:, keep].norm()).item()
                if keep.any() else None}
            err = max(r["max_abs_err"] for r in rows)
            conf = gnn_trunk.backward_config(E, Ds, args[2], c.embed_hidden_size, args[3],
                                             c.embed_layer_n, c.gnn_layer_n, B)
            conf.update(gnn_trunk.backward_attributes(E, Ds, args[2], c.embed_hidden_size,
                                                      args[3], c.embed_layer_n, c.gnn_layer_n))
            # the grid's CTAs all fit on the card at once
            ok = (finite and identical and all(r["ok"] for r in rows)
                  and conf["ctas_per_sm"] >= conf["planned_ctas_per_sm"])
            worst = max(rows, key=lambda r: r["max_abs_err"] / r["bar"])
            bwd_checks.append({"case": name, "E": E, "Ds": Ds, "B": B, "max_abs_err": err,
                               "finite": finite,
                               "two_launches_identical": identical,
                               "ok": ok, "relu_graphs_set_aside": int(aside.sum().item()),
                               "all_graphs_kept": kept,
                               "graphs_off_f64": graphs_off_f64,
                               "worst_leaf": rows.index(worst), **worst, **conf,
                               "leaves": rows if not ok else len(rows)})
            if ok and name.startswith("gated"):
                # the gated shapes' device ms beside their bound
                bufs = (torch.empty_like(src_T), torch.empty_like(adj_T), torch.empty_like(kp.blob),
                        torch.empty((conf["ctas"], kp.blob.numel()), device=dev))
                edges = int(((adj_T > 0) & (adj_T < c.max_edge_dist)).sum().item())
                bw = gnn_trunk.trunk_bwd_work(E, Ds, args[2], kp.F1, args[3], c.embed_layer_n,
                                              c.gnn_layer_n, B, edges, kp.blob.numel())
                b_ms, b_by = bound(bw)
                bwd_checks[-1].update(
                    ms=time_ms(torch, lambda: gnn_trunk.launch_backward_kernel(
                        *args, kp, src_T, adj_T, g, *bufs), reps=10, hide_host=True),
                    bound_ms=b_ms, bound_by=b_by, edges=edges)
                del bufs
            del first, got, want, exact, dflat, ds, da
            torch.cuda.empty_cache()
            if not ok:
                emit({"phase": "backward", "checks": bwd_checks})
                raise AssertionError(f"backward kernel disagrees with the plain version: {name}")
            bwd_max_err = max(bwd_max_err, err)

        # timing at the update's shape (76,800 graphs, E = 6, the default relu)
        gnn = params.actor.gnn_base
        src_T, adj_T = transposed(gnn, upd_node, upd_adj)
        E, Ds = ep.num_entities, src_T.shape[0] // ep.num_entities
        args = trunk_args(cfg, E, Ds)
        g = torch.randn((E * cfg.gnn_hidden_size, B_UPD), generator=gen, device=dev)
        kp = gnn.kernel_params()
        conf = gnn_trunk.backward_config(E, Ds, args[2], kp.F1, args[3], cfg.embed_layer_n,
                                         cfg.gnn_layer_n, B_UPD)
        dsrc, dadj, dblob = torch.empty_like(src_T), torch.empty_like(adj_T), torch.empty_like(kp.blob)
        partial = torch.empty((conf["ctas"], kp.blob.numel()), device=dev)
        bwd_ms = time_ms(torch, lambda: gnn_trunk.launch_backward_kernel(
            *args, kp, src_T, adj_T, g, dsrc, dadj, dblob, partial), reps=10, hide_host=True)
        upd_fwd_ms = time_ms(torch, lambda: gnn_trunk.launch_kernel(
            *args, kp, src_T, adj_T, torch.empty((E * args[3], B_UPD), device=dev)), reps=10,
            hide_host=True)

        def fwd_bwd():
            with torch.enable_grad():
                blob = kp.blob.detach().requires_grad_(True)
                out = gnn_trunk.gnn_trunk_forward(*args, gnn_trunk.KernelParams(blob, kp.F1),
                                                  src_T, adj_T)
                out.backward(g)

        fwd_bwd_ms = time_ms(torch, fwd_bwd, reps=10)
        flat = gnn_trunk.unpack_blob(kp, Ds, args[2], args[3], cfg.embed_layer_n, cfg.gnn_layer_n)
        plain_bwd_ms = time_ms(torch, lambda: gnn_trunk.gnn_trunk_backward_plain(
            *args, flat, src_T, adj_T, g), reps=5, warmup=1)
        upd_edges = int(((adj_T > 0) & (adj_T < cfg.max_edge_dist)).sum().item())
        bwork = gnn_trunk.trunk_bwd_work(E, Ds, args[2], kp.F1, args[3], cfg.embed_layer_n,
                                         cfg.gnn_layer_n, B_UPD, upd_edges, kp.blob.numel())
    bwd_bound_ms, bwd_bound_by = bound(bwork)
    emit({"phase": "backward", "kernel": "gnn_trunk_bwd", "checks": bwd_checks,
          "B": B_UPD, "E": E, "ms": bwd_ms, "forward_kernel_ms": upd_fwd_ms,
          "gnn_trunk_fwd_plus_bwd_ms": fwd_bwd_ms, "plain_ms": plain_bwd_ms,
          "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by, "flops": bwork["flops"],
          "bytes": bwork["bytes"], "edges": upd_edges, **conf,
          "ptxas": built["gnn_trunk_bwd"]["ptxas"], "library_ms": None,
          "library_note": "no PyTorch call computes the trunk's vjp"})

    # ---------------------------------------------------------------- dual
    # both trunks in one launch each way (make_gnn_fused_dual), reached as
    # in the JAX package through nets.gnn_transposed_apply_dual; the policy
    # routes neither, as the JAX package's does not
    def dual_args(c, E, Ds, ga, gc):
        flat = lambda gnn: nets._flatten_gnn_params(gnn, c.embed_layer_n, c.gnn_layer_n)
        return trunk_args(c, E, Ds), ga.kernel_params(), gc.kernel_params(), flat(ga), flat(gc)

    def pair(c, node_feat_dim, state_a, state_c):
        out = []
        for aggr, state in (("node", state_a), ("global", state_c)):
            gnn = nets.GNNBase(c, node_feat_dim, aggr).to(dev)
            gnn.load_state_dict(state)
            out.append(gnn)
        return out

    actor_gnn, critic_gnn = params.actor.gnn_base, params.critic.gnn_base
    tanh_pair = pair(tcfg, ep.node_feat_dim, actor_gnn.state_dict(), critic_gnn.state_dict())
    wide_critic = nets.GNNBase(tcfg, 8, "global")
    wide_critic.init_(torch.Generator().manual_seed(SEED + 3))
    wide_pair = [wide_tanh, wide_critic.to(dev)]
    dual_fwd_checks, dual_bwd_checks, dual_fwd_err, dual_bwd_err = [], [], 0.0, 0.0

    def dual_plan(c, E, Ds, B):
        """The dual forward's plan for B graphs and what the card makes of it."""
        dims = (E, Ds, c.gnn_num_heads, c.embed_hidden_size, c.gnn_hidden_size,
                c.embed_layer_n, c.gnn_layer_n, B)
        return {**gnn_trunk.dual_kernel_config(*dims),
                **gnn_trunk.forward_attributes(*dims, dual=True)}

    with torch.no_grad():
        wide_relu_pair = pair(cfg, 8, wide_gnn.state_dict(), wide_critic.state_dict())
        for name, (ga, gc), c, nd, ad, tol in (
                ("rollout launch batch, random graphs, relu", (actor_gnn, critic_gnn), cfg,
                 rand_node, rand_adj, KERNEL_TOL),
                ("update batch, relu", (actor_gnn, critic_gnn), cfg, upd_node, upd_adj,
                 KERNEL_TOL),
                ("ragged B, tanh", tanh_pair, tcfg, ragged_node, ragged_adj, KERNEL_TOL),
                ("edgeless graphs, relu", (actor_gnn, critic_gnn), cfg, ragged_node, edgeless,
                 KERNEL_TOL),
                ("E=10, relu", wide_relu_pair, cfg, e10k_node, e10k_adj, KERNEL_TOL),
                ("E=20, tanh", wide_pair, tcfg, wide_node, wide_adj, WIDE_TOL)):
            E, B = nd.shape[1], nd.shape[0]
            src_a, adj_T = transposed(ga, nd, ad)
            src_c, _ = transposed(gc, nd, ad)
            args, kp_a, kp_c, fa, fc = dual_args(c, E, src_a.shape[0] // E, ga, gc)
            got = gnn_trunk.gnn_trunk_dual_forward(*args, kp_a, kp_c, src_a, src_c, adj_T)
            # a second launch on the same inputs gives the same bits
            again = gnn_trunk.gnn_trunk_dual_forward(*args, kp_a, kp_c, src_a, src_c, adj_T)
            identical = all(torch.equal(k, k2) for k, k2 in zip(got, again))
            want = gnn_trunk.gnn_trunk_dual_forward_plain(*args, fa, fc, src_a, src_c, adj_T)
            exact = gnn_trunk.gnn_trunk_dual_forward_plain(*args, fa, fc, src_a, src_c, adj_T,
                                                           compute_dtype=torch.float64)
            single = (gnn_trunk.gnn_trunk_forward(*args, kp_a, src_a, adj_T),
                      gnn_trunk.gnn_trunk_forward(*args, kp_c, src_c, adj_T))
            torch.cuda.synchronize()
            err = max((k - p).abs().max().item() for k, p in zip(got, want))
            f64 = [forward_vs_f64(k, p, x, tol is WIDE_TOL) for k, p, x in zip(got, want, exact)]
            # each trunk runs row 1's code: its output equals a row-1 launch
            # bit for bit, whatever the dual's plan
            vs_single = [(k - s1).abs().max().item() for k, s1 in zip(got, single)]
            conf = dual_plan(c, E, args[1], B)
            ok = (all(bool(torch.isfinite(k).all()) and torch.allclose(k, p, **tol)
                      for k, p in zip(got, want)) and all(f[1] for f in f64)
                  and identical and all(torch.equal(k, s1) for k, s1 in zip(got, single))
                  and conf["ctas_per_sm"] >= conf["planned_ctas_per_sm"])
            dual_fwd_checks.append({
                "case": name, "E": E, "B": B, "max_abs_err": err, **tol,
                **{key: [f[0][key] for f in f64] for key in f64[0][0]},
                "vs_two_single_launches_max_abs": vs_single,
                "two_launches_identical": identical, "ok": ok, **conf})
            if not ok:
                emit({"phase": "dual", "forward_checks": dual_fwd_checks})
                raise AssertionError(f"dual forward kernel disagrees with the plain version or "
                                     f"with row 1: {name}")
            dual_fwd_err = max(dual_fwd_err, err)

        for name, (ga, gc), c, nd, ad in (
                ("update batch, tanh", tanh_pair, tcfg, upd_node, upd_adj),
                ("update batch, relu", (actor_gnn, critic_gnn), cfg, upd_node, upd_adj),
                ("ragged B, tanh", tanh_pair, tcfg, ragged_node, ragged_adj),
                ("edgeless graphs, tanh", tanh_pair, tcfg, ragged_node, edgeless),
                ("E=20, tanh", wide_pair, tcfg, wide_node, wide_adj)):
            E, B = nd.shape[1], nd.shape[0]
            src_a, adj_T = transposed(ga, nd, ad)
            src_c, _ = transposed(gc, nd, ad)
            Ds = src_a.shape[0] // E
            args, kp_a, kp_c, fa, fc = dual_args(c, E, Ds, ga, gc)
            g_a, g_c = (torch.randn((E * c.gnn_hidden_size, B), generator=gen, device=dev)
                        for _ in range(2))
            aside = set_aside_relu_flips(c, args, [(fa, src_a), (fc, src_c)], adj_T, [g_a, g_c])
            dba, dbc, dsa, dsc, dadj = gnn_trunk.gnn_trunk_dual_backward(
                *args, kp_a, kp_c, src_a, src_c, adj_T, g_a, g_c)
            got = (grad_leaves(c, Ds, dba, dsa, dadj)[:-2] + grad_leaves(c, Ds, dbc, dsc, dadj)[:-2]
                   + [dsa, dsc, dadj])
            leaves = lambda r: list(r[0]) + list(r[1]) + [r[2], r[3], r[4]]
            want = leaves(gnn_trunk.gnn_trunk_dual_backward_plain(
                *args, fa, fc, src_a, src_c, adj_T, g_a, g_c))
            exact = leaves(gnn_trunk.gnn_trunk_dual_backward_plain(
                *args, fa, fc, src_a, src_c, adj_T, g_a, g_c, compute_dtype=torch.float64))
            sa1 = gnn_trunk.gnn_trunk_backward(*args, kp_a, src_a, adj_T, g_a)
            sc1 = gnn_trunk.gnn_trunk_backward(*args, kp_c, src_c, adj_T, g_c)
            torch.cuda.synchronize()
            finite = all(bool(torch.isfinite(t).all()) for t in got)
            rows = compare_leaves(got, want, exact)
            err = max(r["max_abs_err"] for r in rows)
            worst = max(rows, key=lambda r: r["max_abs_err"] / r["bar"])
            # the dual runs each trunk's backward as a single launch does:
            # parameter gradients and dsrc bit for bit, the summed distance
            # gradient (actor's and critic's added in another order) at the bar
            two = sa1[2] + sc1[2]
            vs_single = {
                "dparams": max((dba - sa1[0]).abs().max().item(), (dbc - sc1[0]).abs().max().item()),
                "dsrc": max((dsa - sa1[1]).abs().max().item(), (dsc - sc1[1]).abs().max().item()),
                "dadj": (dadj - two).abs().max().item(),
                "dadj_bar": GRAD_RTOL * two.abs().max().item() + GRAD_ATOL}
            vs_single_ok = (vs_single["dparams"] == 0.0 and vs_single["dsrc"] == 0.0
                            and vs_single["dadj"] <= vs_single["dadj_bar"])
            attrs = gnn_trunk.backward_attributes(E, Ds, args[2], kp_a.F1, args[3],
                                                  c.embed_layer_n, c.gnn_layer_n, dual=True)
            ok = (finite and vs_single_ok and all(r["ok"] for r in rows)
                  and attrs["ctas_per_sm"] >= attrs["planned_ctas_per_sm"])
            dual_bwd_checks.append({
                "case": name, "E": E, "B": B, "max_abs_err": err, "finite": finite, "ok": ok,
                "relu_graphs_set_aside": int(aside.sum().item()), "worst_leaf": rows.index(worst),
                **worst,
                "vs_two_single_launches_max_abs": vs_single,
                "vs_two_single_launches_ok": vs_single_ok,
                **gnn_trunk.dual_backward_config(E, Ds, args[2], kp_a.F1, args[3],
                                                 c.embed_layer_n, c.gnn_layer_n, B),
                **attrs, "leaves": rows if not ok else len(rows)})
            del got, want, exact, sa1, sc1, two
            torch.cuda.empty_cache()
            if not ok:
                emit({"phase": "dual", "forward_checks": dual_fwd_checks,
                      "backward_checks": dual_bwd_checks})
                raise AssertionError(f"dual backward kernel disagrees with the plain version: {name}")
            dual_bwd_err = max(dual_bwd_err, err)

        # timing (E = 6, relu): the dual forward at four sizes, the dual
        # backward at the update's 76,800 graphs
        E = ep.num_entities
        src_a, adj_T = transposed(actor_gnn, upd_node, upd_adj)
        src_c, _ = transposed(critic_gnn, upd_node, upd_adj)
        Ds = src_a.shape[0] // E
        args, kp_a, kp_c, fa, fc = dual_args(cfg, E, Ds, actor_gnn, critic_gnn)
        n = kp_a.blob.numel()
        # the launch sizes of row 1's paths (768, 3,072, 12,288 and 76,800
        # graphs), each beside two row-1 launches and its bound
        dual_sizes = []
        for B in (768, 3072, B_roll, B_UPD):
            s_a, a_T = transposed(actor_gnn, upd_node[:B], upd_adj[:B])
            s_c, _ = transposed(critic_gnn, upd_node[:B], upd_adj[:B])
            o_a, o_c = (torch.empty((E * args[3], B), device=dev) for _ in range(2))
            reps = 30 if B < B_UPD else 10
            ms = time_ms(torch, lambda: gnn_trunk.launch_dual_kernel(
                *args, kp_a, kp_c, s_a, s_c, a_T, o_a, o_c), reps=reps, hide_host=True)
            two_ms = time_ms(torch, lambda: (
                gnn_trunk.launch_kernel(*args, kp_a, s_a, a_T, o_a),
                gnn_trunk.launch_kernel(*args, kp_c, s_c, a_T, o_c)), reps=reps, hide_host=True)
            p_ms = time_ms(torch, lambda: gnn_trunk.gnn_trunk_dual_forward_plain(
                *args, fa, fc, s_a, s_c, a_T), reps=5, warmup=1)
            edges = int(((a_T > 0) & (a_T < cfg.max_edge_dist)).sum().item())
            w = gnn_trunk.dual_work(E, Ds, args[2], kp_a.F1, args[3], cfg.embed_layer_n,
                                    cfg.gnn_layer_n, B, edges, n)
            b_ms, b_by = bound(w)
            dual_sizes.append({"B": B, "ms": ms, "two_single_ms": two_ms, "plain_ms": p_ms,
                               "bound_ms": b_ms, "bound_by": b_by, "edges": edges, **w,
                               **dual_plan(cfg, E, Ds, B)})
            del s_a, s_c, a_T, o_a, o_c
        upd_row = dual_sizes[-1]
        dual_fwd_ms, two_fwd_ms, plain_dual_fwd_ms = (
            upd_row["ms"], upd_row["two_single_ms"], upd_row["plain_ms"])
        g_a, g_c = (torch.randn((E * args[3], B_UPD), generator=gen, device=dev)
                    for _ in range(2))
        dsa, dsc, dadj = torch.empty_like(src_a), torch.empty_like(src_c), torch.empty_like(adj_T)
        dblobs = torch.empty((2 * n,), device=dev)
        dconf = gnn_trunk.dual_backward_config(E, Ds, args[2], kp_a.F1, args[3], cfg.embed_layer_n,
                                               cfg.gnn_layer_n, B_UPD)
        dpartial = torch.empty((dconf["ctas"], 2 * n), device=dev)
        dual_bwd_ms = time_ms(torch, lambda: gnn_trunk.launch_dual_backward_kernel(
            *args, kp_a, kp_c, src_a, src_c, adj_T, g_a, g_c, dsa, dsc, dadj, dblobs, dpartial),
            reps=10, hide_host=True)
        spartial = torch.empty((gnn_trunk.backward_config(
            E, Ds, args[2], kp_a.F1, args[3], cfg.embed_layer_n, cfg.gnn_layer_n,
            B_UPD)["ctas"], n), device=dev)
        two_bwd_ms = time_ms(torch, lambda: (
            gnn_trunk.launch_backward_kernel(*args, kp_a, src_a, adj_T, g_a, dsa, dadj,
                                             dblobs[:n], spartial),
            gnn_trunk.launch_backward_kernel(*args, kp_c, src_c, adj_T, g_c, dsc, dadj,
                                             dblobs[n:], spartial)), reps=10, hide_host=True)
        plain_dual_bwd_ms = time_ms(torch, lambda: gnn_trunk.gnn_trunk_dual_backward_plain(
            *args, fa, fc, src_a, src_c, adj_T, g_a, g_c), reps=5, warmup=1)
        upd_edges = int(((adj_T > 0) & (adj_T < cfg.max_edge_dist)).sum().item())
        dwork = {"flops": upd_row["flops"], "bytes": upd_row["bytes"]}
        dbwork = gnn_trunk.dual_bwd_work(E, Ds, args[2], kp_a.F1, args[3], cfg.embed_layer_n,
                                         cfg.gnn_layer_n, B_UPD, upd_edges, n)
    dual_fwd_bound, dual_fwd_by = upd_row["bound_ms"], upd_row["bound_by"]
    dual_bwd_bound, dual_bwd_by = bound(dbwork)

    # the path: both trunks with a gradient through gnn_transposed_apply_dual
    # at the update's shape, counted, then profiled
    upd_aid = torch.randint(0, ep.num_agents, (B_UPD, 1), generator=gen, device=dev)
    dual_weights = list(actor_gnn.parameters()) + list(critic_gnn.parameters())

    def dual_path():
        na, nc = nets.gnn_transposed_apply_dual(cfg, actor_gnn, critic_gnn, upd_node, upd_adj,
                                                upd_aid, cfg.global_aggr_type)
        return torch.autograd.grad((na ** 2).sum() + (nc ** 2).sum(), dual_weights)

    counters = (gnn_trunk.gnn_trunk_forward, gnn_trunk.gnn_trunk_backward,
                gnn_trunk.gnn_trunk_dual_forward, gnn_trunk.gnn_trunk_dual_backward)
    for f in counters:
        f.launches = 0
    dual_grads = dual_path()
    torch.cuda.synchronize()
    path_launches = [f.launches for f in counters]
    if path_launches != [0, 0, 1, 1]:
        raise AssertionError(f"gnn_transposed_apply_dual launched (fwd, bwd, dual fwd, dual bwd) "
                             f"{path_launches}, expected [0, 0, 1, 1]")
    if not all(bool(torch.isfinite(gr).all()) for gr in dual_grads):
        raise AssertionError("non-finite gradients through gnn_transposed_apply_dual")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAUSE_S)
        dual_path()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAUSE_S)
    names = [(e.key, e.count) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    count = lambda pattern: sum(c for k, c in names if re.search(pattern, k))
    profiled = {"gnn_trunk_dual_fwd_panel_kernel": count("gnn_trunk_dual_fwd_panel_kernel"),
                "gnn_trunk_dual_bwd_kernel": count("gnn_trunk_dual_bwd_kernel"),
                "sum_rows_kernel": count("sum_rows_kernel"),
                "single trunk kernels": count("gnn_trunk_fwd_panel_kernel")
                + count("gnn_trunk_bwd_kernel")}
    if list(profiled.values()) != [1, 1, 1, 0]:
        raise AssertionError(f"the dual path's profile counts {profiled}: {names}")
    dual_plans_ok = all(r["ctas_per_sm"] >= r["planned_ctas_per_sm"] for r in dual_sizes)
    emit({"phase": "dual", "kernels": ["gnn_trunk_dual_fwd", "gnn_trunk_dual_bwd"],
          "forward_checks": dual_fwd_checks, "backward_checks": dual_bwd_checks,
          "B": B_UPD, "E": E, "edges": upd_edges,
          "forward": {"ms": dual_fwd_ms, "two_single_ms": two_fwd_ms,
                      "plain_ms": plain_dual_fwd_ms, "bound_ms": dual_fwd_bound,
                      "bound_by": dual_fwd_by, **dwork, "sizes": dual_sizes},
          "backward": {"ms": dual_bwd_ms, "two_single_ms": two_bwd_ms,
                       "plain_ms": plain_dual_bwd_ms, "bound_ms": dual_bwd_bound,
                       "bound_by": dual_bwd_by, **dbwork, **dconf},
          "path_launches": {"dual_fwd": path_launches[2], "dual_bwd": path_launches[3],
                            "single": path_launches[:2]},
          "profiled_kernels": profiled,
          "ptxas": {k: built[k]["ptxas"] for k in ("gnn_trunk_dual_fwd", "gnn_trunk_dual_bwd")},
          "library_ms": None, "library_note": "no PyTorch call computes either trunk"})
    if not dual_plans_ok:
        raise AssertionError("the dual forward's plan counts more CTAs an SM than the card holds")

    # ---------------------------------------------------------------- v2
    # the trunk forward in the v2 formulation (make_gnn_forward_v2), held
    # against its plain version and, bit for bit, against the trunk forward
    # kernel (row 1 of the kernel table), whose body and plan it runs;
    # nothing routes it, as in the JAX package
    rtcfg = ModelConfig(max_edge_dist=cfg.max_edge_dist, embed_use_relu=True,
                        gnn_use_relu=False)

    def as_cfg(gnn, c, node_feat_dim):
        other = nets.GNNBase(c, node_feat_dim, "node").to(dev)
        other.load_state_dict(gnn.state_dict())
        return other

    def v2_flat(gnn, c, E):
        return gnn_trunk_v2.flatten_gnn_params_v2(gnn.flax_tree(), E, c.gnn_num_heads,
                                                  c.gnn_hidden_size, c.embed_layer_n,
                                                  c.gnn_layer_n)

    def v2_plan(c, E, Ds, B):
        """The v2 kernel's plan for B graphs, what the card makes of it, and
        whether the plan is row 1's."""
        dims = (E, Ds, c.gnn_num_heads, c.gnn_hidden_size, c.embed_layer_n, c.gnn_layer_n, B)
        conf = gnn_trunk_v2.v2_config(*dims)
        row1 = gnn_trunk.kernel_config(*dims[:3], c.embed_hidden_size, *dims[3:])
        return {**conf, **gnn_trunk_v2.v2_attributes(*dims), "row1_plan": conf == row1}

    def v2_vs_row1(gnn, c, nd, ad, tol):
        """The v2 kernel against the v2 plain version on one input, at
        ``tol`` and the float64 criterion, and against row 1's kernel on the
        same weights bit for bit (the v2 staging's floats, ``blob_from_v2``,
        are row 1's buffer); two launches give the same bits, the plan is
        row 1's and its CTAs an SM are resident."""
        src_T, adj_T = transposed(gnn, nd, ad)
        E = nd.shape[1]
        args = trunk_args(c, E, src_T.shape[0] // E)
        flat2 = v2_flat(gnn, c, E)
        got = gnn_trunk_v2.gnn_forward_v2(*args, flat2, src_T, adj_T)
        identical = torch.equal(got, gnn_trunk_v2.gnn_forward_v2(*args, flat2, src_T, adj_T))
        want = gnn_trunk_v2.gnn_forward_v2_plain(*args, flat2, src_T, adj_T)
        exact = gnn_trunk_v2.gnn_forward_v2_plain(*args, flat2, src_T, adj_T,
                                                  compute_dtype=torch.float64)
        kp = gnn.kernel_params()
        row1 = gnn_trunk.gnn_trunk_forward(*args, kp, src_T, adj_T)
        torch.cuda.synchronize()
        staged = torch.equal(gnn_trunk_v2.blob_from_v2(flat2, *args[:6]).blob, kp.blob)
        wide = tol is WIDE_TOL
        f64, f64_ok = forward_vs_f64(got, want, exact, wide)
        f64_r1, _ = forward_vs_f64(got, row1, exact, wide)
        conf = v2_plan(c, E, args[1], nd.shape[0])
        ok = (bool(torch.isfinite(got).all()) and torch.allclose(got, want, **tol) and f64_ok
              and torch.equal(got, row1) and identical and staged and conf["row1_plan"]
              and conf["ctas_per_sm"] >= conf["planned_ctas_per_sm"])
        return {"E": E, "B": nd.shape[0], "max_abs_err": (got - want).abs().max().item(),
                "vs_row1_max_abs_err": (got - row1).abs().max().item(), **tol, **f64,
                "row1_vs_f64": f64_r1["plain_vs_f64"],
                "row1_vs_f64_rel_l2": f64_r1["plain_vs_f64_rel_l2"],
                "two_launches_identical": identical, "staged_blob_is_row1s": staged, "ok": ok,
                **conf}

    v2_checks, v2_max_err = [], 0.0
    with torch.no_grad():
        relu_tanh_gnn = as_cfg(params.critic.gnn_base, rtcfg, ep.node_feat_dim)
        wide_relu_tanh = as_cfg(wide_gnn, rtcfg, 8)
        e10_node, e10_adj = random_graphs(B_roll, 10, cfg.max_edge_dist, gen)
        env_node, env_adj = rollout_graphs()
        for name, gnn, c, nd, ad, tol in (
                ("rollout launch batch, random graphs, relu", params.actor.gnn_base, cfg,
                 rand_node, rand_adj, KERNEL_TOL),
                ("rollout launch batch, env reset graphs, relu", params.actor.gnn_base, cfg,
                 env_node, env_adj, KERNEL_TOL),
                ("update batch, relu", params.actor.gnn_base, cfg, upd_node, upd_adj,
                 KERNEL_TOL),
                ("ragged B, relu/tanh", relu_tanh_gnn, rtcfg, ragged_node, ragged_adj,
                 KERNEL_TOL),
                ("edgeless graphs, relu", params.actor.gnn_base, cfg, ragged_node, edgeless,
                 KERNEL_TOL),
                ("E=10, relu", wide_gnn, cfg, e10_node, e10_adj, KERNEL_TOL),
                ("E=20, relu/tanh", wide_relu_tanh, rtcfg, wide_node, wide_adj, WIDE_TOL)):
            row = {"case": name, **v2_vs_row1(gnn, c, nd, ad, tol)}
            v2_checks.append(row)
            torch.cuda.empty_cache()
            if not row["ok"]:
                emit({"phase": "v2", "checks": v2_checks})
                raise AssertionError(f"v2 kernel disagrees with its plain version or with the "
                                     f"trunk forward kernel: {name}")
            v2_max_err = max(v2_max_err, row["max_abs_err"])

        # timing (E = 6, relu) at the launch sizes of row 1's paths (768,
        # 3,072, 12,288 and 76,800 graphs), each beside row 1 and its bound
        gnn = params.actor.gnn_base
        E = ep.num_entities
        v2_timing = {}
        for B in (768, 3072, B_roll, B_UPD):
            src_T, adj_T = transposed(gnn, upd_node[:B], upd_adj[:B])
            args = trunk_args(cfg, E, src_T.shape[0] // E)
            flat2 = v2_flat(gnn, cfg, E)
            kp = gnn.kernel_params()
            out = torch.empty((E * args[3], B), device=dev)
            reps = 30 if B < B_UPD else 10
            v2_kernel_ms = time_ms(torch, lambda: gnn_trunk_v2.launch_v2_kernel(
                *args, flat2, src_T, adj_T, out), reps=reps, hide_host=True)
            v2_row1_ms = time_ms(torch, lambda: gnn_trunk.launch_kernel(
                *args, kp, src_T, adj_T, out), reps=reps, hide_host=True)
            v2_plain_ms = time_ms(torch, lambda: gnn_trunk_v2.gnn_forward_v2_plain(
                *args, flat2, src_T, adj_T), reps=5, warmup=1)
            v2_edges = int(((adj_T > 0) & (adj_T < cfg.max_edge_dist)).sum().item())
            n_v2 = sum(t.numel() for t in flat2)
            v2_w = gnn_trunk_v2.v2_work(*args[:6], B, v2_edges, n_v2)
            v2_bound, v2_by = bound(v2_w)
            dense_bound, dense_by = bound({"flops": v2_w["dense_flops"], "bytes": v2_w["bytes"]})
            v2_timing[B] = {"B": B, "ms": v2_kernel_ms, "row1_ms": v2_row1_ms,
                            "plain_ms": v2_plain_ms, "bound_ms": v2_bound, "bound_by": v2_by,
                            "dense_bound_ms": dense_bound, "dense_bound_by": dense_by,
                            "edges": v2_edges, "v2_param_floats": n_v2, **v2_w,
                            **v2_plan(cfg, E, args[1], B)}

        # the path: one call through make_gnn_forward_v2, at the rollout's shape
        src_T, adj_T = transposed(gnn, rand_node, rand_adj)
        args = trunk_args(cfg, E, src_T.shape[0] // E)
        fwd_v2 = gnn_trunk_v2.make_gnn_forward_v2(*args)
        flat2 = v2_flat(gnn, cfg, E)
        all_counters = counters + (gnn_trunk_v2.gnn_forward_v2,)
        for f in all_counters:
            f.launches = 0
        v2_out = fwd_v2(flat2, src_T, adj_T)
        torch.cuda.synchronize()
        v2_path_launches = [f.launches for f in all_counters]
        if v2_path_launches != [0, 0, 0, 0, 1] or not bool(torch.isfinite(v2_out).all()):
            raise AssertionError(f"make_gnn_forward_v2 launched (fwd, bwd, dual fwd, dual bwd, "
                                 f"v2) {v2_path_launches}, expected [0, 0, 0, 0, 1]")
        # the same call profiled: one launch of the v2 kernel, no row-1
        # kernel, in a window with host pauses at both ends (PROFILE_PAUSE_S)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAUSE_S)
            fwd_v2(flat2, src_T, adj_T)
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAUSE_S)
    names = [(e.key, e.count) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    count = lambda pattern: sum(c for k, c in names if re.search(pattern, k))
    v2_profiled = {"gnn_forward_v2_panel_kernel": count("gnn_forward_v2_panel_kernel"),
                   "row 1 kernel": count("gnn_trunk_fwd_panel_kernel")}
    if list(v2_profiled.values()) != [1, 0]:
        raise AssertionError(f"the v2 path's profile counts {v2_profiled}: {names}")
    v2_ms = v2_timing[B_roll]
    emit({"phase": "v2", "kernel": "gnn_forward_v2", "checks": v2_checks,
          "timing": list(v2_timing.values()), "path_launches": v2_path_launches[-1],
          "profiled_kernels": v2_profiled,
          "zero_blocks": "skipped: the kernel stages one diagonal block of each matrix",
          "ptxas": built["gnn_forward_v2"]["ptxas"], "library_ms": None,
          "library_note": "no PyTorch call computes the trunk"})
    if not all(r["ctas_per_sm"] >= r["planned_ctas_per_sm"] for r in v2_timing.values()):
        raise AssertionError("the v2 kernel's plan counts more CTAs an SM than the card holds")

    # ---------------------------------------------------------------- rollout
    runner = Runner(env_params=ep, policy=policy, trainer=rollout_trainer,
                    n_rollout_threads=N_ENVS, episode_length=STEPS)
    warm = Runner(env_params=ep, policy=policy, trainer=rollout_trainer,
                  n_rollout_threads=N_ENVS, episode_length=2)
    warm.collect(ts, warm.init_carry(SEED + 3))
    torch.cuda.synchronize()

    gnn_trunk.gnn_trunk_forward.launches = 0
    t0 = time.perf_counter()
    carry0 = runner.init_carry(SEED)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, buf, _ = runner.collect(ts, carry0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    init_seconds = t1 - t0
    launches = gnn_trunk.gnn_trunk_forward.launches
    expected = 2 * STEPS + 1  # actor + critic trunk per step, bootstrap critic
    if launches != expected:
        raise AssertionError(f"trunk kernel launched {launches} times, expected {expected}")
    for k in ("obs", "node_obs", "adj", "rewards", "value_preds", "action_log_probs",
              "returns", "rnn_states", "rnn_states_critic"):
        if not torch.isfinite(getattr(buf, k)).all():
            raise AssertionError(f"buffer {k} is not finite")
    if tuple(buf.returns.shape) != (STEPS + 1, N_ENVS, ep.num_agents, 1):
        raise AssertionError(f"returns shape {tuple(buf.returns.shape)}")

    # one rollout step from the same carry: card (kernel) vs CPU (plain)
    sub = 256
    cpu_policy = GRMAPPOPolicy(cfg, dims, device="cpu")
    cpu_params = cpu_policy.init_params(SEED)
    cpu_params.actor.load_state_dict(params.actor.state_dict())
    cpu_params.critic.load_state_dict(params.critic.state_dict())
    cmp_ref = {}
    for side, pol, prm, d in (("card", policy, params, dev),
                              ("cpu", cpu_policy, cpu_params, torch.device("cpu"))):
        c0 = carry0
        B, N, E = sub, ep.num_agents, ep.num_entities
        mv = lambda x: x[:sub].to(d)
        obs, node_obs, adj = mv(c0.obs), mv(c0.node_obs), mv(c0.adj)
        fl = lambda x: x.reshape((B * N,) + x.shape[2:])
        share = obs.reshape(B, 1, -1).expand(B, N, -1)
        aid = mv(c0.agent_id)
        adj_rep = adj[:, None].expand(B, N, E, E)
        h = torch.zeros((B * N, cfg.recurrent_n, cfg.hidden_size), device=d)
        m = torch.ones((B * N, 1), device=d)
        vals, acts, logp, h_a, h_c = pol.get_actions(
            prm, None, fl(share), fl(obs), fl(node_obs), fl(adj_rep), fl(aid),
            h, h, m, None, deterministic=True)
        state = map_state(lambda x: x[:sub].to(d), c0.env_state)
        _, st = env_mod.step(ep, state, acts.reshape(B, N), torch.Generator(device=d))
        cmp_ref[side] = {"values": vals, "actions": acts, "logp": logp, "h_a": h_a,
                         "h_c": h_c, "obs": st.obs, "reward": st.reward,
                         "node_obs": st.node_obs, "adj": st.adj}
    step_err = {}
    for k, v in cmp_ref["card"].items():
        w = cmp_ref["cpu"][k]
        v = v.cpu()
        if k == "actions":
            if not torch.equal(v, w):
                raise AssertionError("card and CPU rollout steps chose different actions")
            continue
        step_err[k] = (v - w).abs().max().item()
        if not torch.allclose(v, w, **NET_TOL):
            raise AssertionError(f"card and CPU rollout steps disagree on {k}")

    # where the step's time goes, from a profiled short window
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def collect_profile(runner_, ts_, seed, collect_seconds, prof_steps=5):
        """A profiled collect of ``prof_steps`` steps of ``runner_``'s envs,
        per step (its one bootstrap critic call spread over them); the busy
        share divides the device time by the unprofiled step of a collect of
        STEPS steps that took ``collect_seconds``."""
        prof_runner = dataclasses.replace(runner_, episode_length=prof_steps)
        pc = prof_runner.init_carry(seed)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            tw = time.perf_counter()
            prof_runner.collect(ts_, pc)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - tw) * 1e3
        avg = prof.key_averages()
        dev_evts = [e for e in avg if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.self_device_time_total for e in dev_evts)
        n_kern = sum(e.count for e in dev_evts)
        trunk_us = sum(e.self_device_time_total for e in dev_evts if "gnn_trunk_fwd" in e.key)
        launch_us = sum(e.self_cpu_time_total for e in avg if e.key == "cudaLaunchKernel")
        dev_ms_step = dev_us / 1e3 / prof_steps
        return {
            "steps": prof_steps, "profiled_wall_ms_per_step": wall_ms / prof_steps,
            "device_ms_per_step": dev_ms_step,
            "device_busy_share": (dev_ms_step / (collect_seconds * 1e3 / STEPS)
                                  if dev_us > 0 else None),
            "kernels_per_step": n_kern / prof_steps,
            "trunk_kernel_ms_per_step": trunk_us / 1e3 / prof_steps,
            "cudaLaunchKernel_host_ms_per_step": launch_us / 1e3 / prof_steps,
        }

    profile = collect_profile(runner, ts, SEED + 4, seconds)
    emit({"phase": "rollout", "envs": N_ENVS, "agents": ep.num_agents, "steps": STEPS,
          "init_carry_seconds": init_seconds, "collect_seconds": seconds,
          "wall_ms_per_step": seconds * 1e3 / STEPS,
          "env_steps_per_s": N_ENVS * STEPS / seconds,
          "trunk_launches": launches, "expected_launches": expected,
          "mean_reward": buf.rewards.mean().item(), "card_vs_cpu_step_max_abs_err": step_err,
          "card_vs_cpu_envs": sub, "profile": profile})

    # ---------------------------------------------------------------- eval
    gnn_trunk.gnn_trunk_forward.launches = 0
    t0 = time.perf_counter()
    metrics = runner.eval_episode(ts, SEED + 5, EVAL_ENVS)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = gnn_trunk.gnn_trunk_forward.launches
    if eval_launches != ep.episode_length:
        raise AssertionError(f"eval trunk launches {eval_launches} != {ep.episode_length}")
    if not all(v == v and abs(v) != float("inf") for v in metrics.values()):
        raise AssertionError(f"non-finite eval metrics {metrics}")
    emit({"phase": "eval", "envs": EVAL_ENVS, "seconds": eval_s,
          "trunk_launches": eval_launches, "metrics": metrics})

    # ---------------------------------------------------------------- train
    trainer = GRMAPPOTrainer(policy, ppo_epoch=PPO_EPOCH, num_mini_batch=1,
                             data_chunk_length=CHUNK)
    tts = trainer.init_state(SEED)
    train_runner = Runner(env_params=ep, policy=policy, trainer=trainer,
                          n_rollout_threads=TRAIN_ENVS, episode_length=STEPS)
    tgen = torch.Generator(device=dev).manual_seed(SEED + 6)
    tcarry = train_runner.init_carry(SEED + 6)
    tts, tcarry, _, _ = train_runner.train_episode(tts, tcarry, tgen)  # warm-up
    torch.cuda.synchronize()
    weights = lambda: [p.detach().clone() for m in (tts.params.actor, tts.params.critic)
                       for p in m.parameters()]
    before = weights()
    fwd_expected = 2 * STEPS + 1 + 2 * PPO_EPOCH  # collect + actor and critic per epoch
    bwd_expected = 2 * PPO_EPOCH
    episodes = []
    for _ in range(TRAIN_EPISODES):
        gnn_trunk.gnn_trunk_forward.launches = 0
        gnn_trunk.gnn_trunk_backward.launches = 0
        t0 = time.perf_counter()
        tts, tcarry, info, env_info = train_runner.train_episode(tts, tcarry, tgen)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        fl, bl = gnn_trunk.gnn_trunk_forward.launches, gnn_trunk.gnn_trunk_backward.launches
        if (fl, bl) != (fwd_expected, bwd_expected):
            raise AssertionError(f"train episode launched the trunk kernels {fl} (forward) and "
                                 f"{bl} (backward) times, expected {fwd_expected} and "
                                 f"{bwd_expected}")
        info = {k: v.item() for k, v in info.items()}
        if not all(v == v and abs(v) != float("inf") for v in info.values()):
            raise AssertionError(f"non-finite train info {info}")
        episodes.append({"seconds": sec, "env_steps_per_s": TRAIN_ENVS * STEPS / sec,
                         "forward_launches": fl, "backward_launches": bl, **info})
    after = weights()
    changed = sum(not torch.equal(a, b) for a, b in zip(before, after))
    if changed < len(before):
        raise AssertionError(f"only {changed} of {len(before)} weight tensors changed")

    def update_profile_of(runner_, ts_, carry_, pbuf=None):
        """Where the update's time goes: a collect of ``runner_``'s (unless
        a buffer ``pbuf`` is given), then a 2-epoch update unprofiled and
        profiled on its buffer.  Returns the profile and the carry after the
        collect."""
        prof_epochs = 2
        prof_trainer = GRMAPPOTrainer(runner_.policy, ppo_epoch=prof_epochs,
                                      data_chunk_length=CHUNK)
        t0 = time.perf_counter()
        if pbuf is None:
            carry_, pbuf, _ = runner_.collect(ts_, carry_)
        torch.cuda.synchronize()
        collect_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        prof_trainer.train(ts_, pbuf)
        torch.cuda.synchronize()
        epoch_ms = (time.perf_counter() - t0) * 1e3 / prof_epochs
        with torch.profiler.profile(activities=acts) as prof:
            tw = time.perf_counter()
            prof_trainer.train(ts_, pbuf)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - tw) * 1e3
        avg = prof.key_averages()
        dev_evts = [e for e in avg if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.self_device_time_total for e in dev_evts)
        by = lambda key: sum(e.self_device_time_total for e in dev_evts if key in e.key)
        dev_ms_epoch = dev_us / 1e3 / prof_epochs
        top = sorted(dev_evts, key=lambda e: -e.self_device_time_total)[:8]
        return {
            "epochs": prof_epochs, "unprofiled_wall_ms_per_epoch": epoch_ms,
            "profiled_wall_ms_per_epoch": prof_wall_ms / prof_epochs,
            "device_ms_per_epoch": dev_ms_epoch,
            "device_busy_share": dev_ms_epoch / epoch_ms if dev_us > 0 else None,
            "kernels_per_epoch": sum(e.count for e in dev_evts) / prof_epochs,
            "trunk_fwd_kernel_ms_per_epoch": by("gnn_trunk_fwd") / 1e3 / prof_epochs,
            "trunk_bwd_kernel_ms_per_epoch": by("gnn_trunk_bwd") / 1e3 / prof_epochs,
            # the trunk kernels' launches by the profiler's kernel names
            "trunk_kernel_launches": sum(e.count for e in dev_evts
                                         if re.search(r"gnn_(trunk|forward)", e.key)),
            # the trunks' attention softmax ops (the heads take log_softmax)
            "softmax_ops_per_epoch": sum(e.count for e in avg
                                         if e.key == "aten::_softmax") / prof_epochs,
            "cudaLaunchKernel_host_ms_per_epoch": sum(
                e.self_cpu_time_total for e in avg
                if e.key == "cudaLaunchKernel") / 1e3 / prof_epochs,
            "top_device_ms_per_epoch": {e.key[:60]: e.self_device_time_total / 1e3 / prof_epochs
                                        for e in top},
            "collect_seconds": collect_s,
        }, carry_

    update_profile, tcarry = update_profile_of(train_runner, tts, tcarry)

    def first_epoch_grads(env_params, envs, specs, cfg_kw=None, policy_kw=None, **runner_kw):
        """The first epoch's gradients of one update on each side of
        ``specs`` ({side: (device, compute dtype[, ModelConfig fields[,
        GRMAPPOPolicy arguments]])}, the first side on the card), from the
        same weights (tanh activations everywhere, the fields of ``cfg_kw``
        and the arguments of ``policy_kw`` on every side) and one buffer (a
        collect of ``envs`` envs of ``env_params`` by the first side, its
        ``Runner`` given ``runner_kw``: the HJ table, the centralized V).
        Returns the sides' trainers and states, their gradients by leaf (on
        the CPU), their losses and the buffer on the card and on the CPU."""
        dims_ = PolicyDims(env_params.obs_dim, env_params.obs_dim * env_params.num_agents,
                           env_params.num_entities, env_params.node_feat_dim,
                           env_params.num_actions)
        sides = {}
        for side, (d, dt, *side_kw) in specs.items():
            cfg_ = ModelConfig(max_edge_dist=env_params.cfg.coordination_range, use_relu=False,
                               embed_use_relu=False, gnn_use_relu=False, compute_dtype=dt,
                               **(cfg_kw or {}), **(side_kw[0] if side_kw else {}))
            pol_kw = {**(policy_kw or {}), **(side_kw[1] if len(side_kw) > 1 else {})}
            tr = GRMAPPOTrainer(GRMAPPOPolicy(cfg_, dims_, device=d, **pol_kw), ppo_epoch=1,
                                data_chunk_length=CHUNK)
            sides[side] = (tr, tr.init_state(SEED + 7))
        tr_c, ts_c = next(iter(sides.values()))
        cmp_runner = Runner(env_params=env_params, policy=tr_c.policy, trainer=tr_c,
                            n_rollout_threads=envs, episode_length=STEPS, **runner_kw)
        _, buf_c, _ = cmp_runner.collect(ts_c, cmp_runner.init_carry(SEED + 7))
        buf_h = dataclasses.replace(buf_c, **{
            f.name: getattr(buf_c, f.name).cpu() for f in dataclasses.fields(buf_c)
            if getattr(buf_c, f.name) is not None})
        first, totals = {}, {}
        for side, (tr, st) in sides.items():
            buf = buf_c if tr.policy.device.type == "cuda" else buf_h
            batch = tr._time_major(tr.chunks(st, buf))
            vn = vn_update(st.vn, batch["returns"].reshape(-1, 1))
            named = [(f"{m}.{n}", p) for m in ("actor", "critic")
                     for n, p in getattr(st.params, m).named_parameters()]
            total, _ = tr.loss(st.params, vn, batch)
            grads = torch.autograd.grad(total, [p for _, p in named], allow_unused=True)
            first[side] = {n: (torch.zeros_like(p) if gr is None else gr).detach().cpu()
                           for (n, p), gr in zip(named, grads)}
            totals[side] = total.item()
        return sides, first, totals, buf_c, buf_h

    def update_card_vs_cpu(env_params, envs=CMP_ENVS, cfg_kw=None, specs=None, policy_kw=None,
                           **runner_kw):
        """One update on the two sides of ``specs`` (by default the card's
        kernels against the CPU's plain versions; ``first_epoch_grads``'
        form), from the same buffer (a collect of ``envs`` envs of
        ``env_params`` by the first side, on the card) and weights, with tanh
        activations everywhere: the first side's first-epoch gradients
        against the second's at the JAX bar, per leaf, and the update's
        losses and norms at LOSS_RTOL / LOSS_ATOL.  Returns the worst
        gradient's ratio to its bar, the largest gradient error and both
        sides' train info."""
        specs = specs or {"card": (dev, "float32"), "cpu": (torch.device("cpu"), "float32")}
        sides, first, _, buf_c, buf_h = first_epoch_grads(env_params, envs, specs, cfg_kw,
                                                          policy_kw, **runner_kw)
        held, ref = list(sides)
        grad_err, worst_ratio = {}, 0.0
        for n, want in first[ref].items():
            err = (first[held][n] - want).abs().max().item()
            bar = GRAD_RTOL * want.abs().max().item() + GRAD_ATOL
            worst_ratio = max(worst_ratio, err / bar)
            grad_err[n] = err
            if err > bar:
                raise AssertionError(f"{held} and {ref} update gradients disagree on {n}: "
                                     f"{err} > {bar}")
        infos = {side: {k: v.item() for k, v in tr.train(
                    st, buf_c if tr.policy.device.type == "cuda" else buf_h)[1].items()}
                 for side, (tr, st) in sides.items()}
        for k, want in infos[ref].items():
            if abs(infos[held][k] - want) > LOSS_RTOL * abs(want) + LOSS_ATOL:
                raise AssertionError(f"{held} and {ref} update disagree on {k}: "
                                     f"{infos[held][k]} vs {want}")
        return worst_ratio, max(grad_err.values()), infos

    worst_ratio, max_grad_err, infos = update_card_vs_cpu(ep)
    mean_of = lambda key: statistics.mean(e[key] for e in episodes)
    emit({"phase": "train", "envs": TRAIN_ENVS, "agents": ep.num_agents, "steps": STEPS,
          "ppo_epoch": PPO_EPOCH, "num_mini_batch": 1, "data_chunk_length": CHUNK,
          "graphs_per_trunk_call": B_UPD, "episodes": episodes,
          "seconds_per_episode": mean_of("seconds"),
          "env_steps_per_s": mean_of("env_steps_per_s"),
          "weight_tensors_changed": changed, "update_profile": update_profile,
          "card_vs_cpu": {"envs": CMP_ENVS, "first_epoch_grad_worst_ratio_to_bar": worst_ratio,
                          "first_epoch_grad_max_abs_err": max_grad_err,
                          "train_info_card": infos["card"], "train_info_cpu": infos["cpu"]}})

    # ---------------------------------------------------------------- cli
    # the train entry point as a user runs it: three flagship episodes with
    # in-training evaluation, then the last one again, resumed from its checkpoint
    from contracts_marl_aam_corridors_tpu_torch.cli import train as cli_train
    from contracts_marl_aam_corridors_tpu_torch.config.flags import build_model_config, parse_all
    from contracts_marl_aam_corridors_tpu_torch.utils.checkpoint import restore_checkpoint

    cli_argv = ["--num_agents", str(ep.num_agents), "--n_rollout_threads", str(TRAIN_ENVS),
                "--episode_length", str(STEPS), "--ppo_epoch", str(PPO_EPOCH),
                "--num_mini_batch", "1", "--data_chunk_length", str(CHUNK), "--use_eval",
                "--log_interval", "1", "--seed", str(SEED), "--compute_dtype", "float32"]
    steps_for = lambda episodes: ["--num_env_steps", str(episodes * STEPS * TRAIN_ENVS)]
    n_evals = 1  # at episode 0: the default --eval_interval is 25
    with tempfile.TemporaryDirectory() as tmp:
        argv = cli_argv + ["--run_dir", tmp] + steps_for(CLI_EPISODES)
        gnn_trunk.gnn_trunk_forward.launches = 0
        gnn_trunk.gnn_trunk_backward.launches = 0
        t0 = time.perf_counter()
        run_dir, cli_ts = cli_train.main(argv)
        torch.cuda.synchronize()
        cli_seconds = time.perf_counter() - t0
        fl, bl = gnn_trunk.gnn_trunk_forward.launches, gnn_trunk.gnn_trunk_backward.launches
        want = (CLI_EPISODES * fwd_expected + n_evals * ep.episode_length,
                CLI_EPISODES * bwd_expected)
        if (fl, bl) != want:
            raise AssertionError(f"the train CLI launched the trunk kernels {(fl, bl)} times "
                                 f"(forward, backward), expected {want}")
        with open(Path(run_dir) / "metrics.jsonl") as f:
            records = [json.loads(line) for line in f]
        train_recs = [r for r in records if "value_loss" in r]
        eval_recs = [r for r in records if "eval_success_rate" in r]
        if len(train_recs) != CLI_EPISODES or len(eval_recs) != n_evals:
            raise AssertionError(f"metrics.jsonl holds {len(train_recs)} episodes and "
                                 f"{len(eval_recs)} evaluations")
        if not all(v == v and abs(v) != float("inf") for r in records for v in r.values()):
            raise AssertionError("non-finite metrics in metrics.jsonl")
        # each episode's seconds from the log's clock, the evaluation after
        # episode 0 left out
        marks = [0.0, train_recs[0]["wall_s"], eval_recs[0]["wall_s"]] + [
            r["wall_s"] for r in train_recs[1:]]
        episode_seconds = [marks[1] - marks[0]] + [b - a for a, b in zip(marks[2:], marks[3:])]

        models = Path(run_dir) / "models"
        _, _, cli_trainer, _ = cli_train.build(parse_all(argv))
        restored, saved = restore_checkpoint(str(models), cli_trainer.init_state(SEED + 99))
        held, back = train_state_tensors(cli_ts), train_state_tensors(restored)
        differ = sorted(k for k, v in held.items() if not (
            torch.equal(back[k], v) and back[k].dtype == v.dtype and back[k].device == v.device
            if isinstance(v, torch.Tensor) else back.get(k) == v))
        if saved != CLI_EPISODES - 1 or set(back) != set(held) or differ:
            raise AssertionError(f"the checkpoint of episode {saved} does not restore the run's "
                                 f"state bit for bit: {differ[:5]}")

        gnn_trunk.gnn_trunk_forward.launches = 0
        gnn_trunk.gnn_trunk_backward.launches = 0
        t0 = time.perf_counter()
        # the resumed run restarts at the saved episode, as the JAX CLI does
        cli_train.main(cli_argv + ["--run_dir", tmp, "--model_dir", str(models)]
                       + steps_for(CLI_EPISODES))
        torch.cuda.synchronize()
        resume_seconds = time.perf_counter() - t0
        resumed = (gnn_trunk.gnn_trunk_forward.launches, gnn_trunk.gnn_trunk_backward.launches)
        with open(models / "latest.json") as f:
            latest = json.load(f)["episode"]
        if resumed != (fwd_expected, bwd_expected) or latest != CLI_EPISODES - 1:
            raise AssertionError(f"the resumed run launched {resumed} and saved episode {latest}")
        saved_files = sorted(p.name for p in models.iterdir())
    emit({"phase": "cli", "argv": cli_argv + steps_for(CLI_EPISODES),
          "episodes": CLI_EPISODES, "seconds": cli_seconds,
          "episode_seconds": episode_seconds,
          "seconds_per_episode": statistics.mean(episode_seconds),
          "env_steps_per_s": TRAIN_ENVS * STEPS / statistics.mean(episode_seconds),
          "eval_seconds": eval_recs[0]["wall_s"] - train_recs[0]["wall_s"],
          "trunk_launches": {"forward": fl, "backward": bl, "expected": list(want)},
          "last_episode": {k: train_recs[-1][k] for k in (
              "average_episode_rewards", "value_loss", "policy_loss", "env_steps_per_sec")},
          "eval": {k: eval_recs[0][k] for k in ("eval_average_episode_rewards",
                                                 "eval_success_rate")},
          "restore": {"episode": saved, "tensors_and_values": len(held), "bit_for_bit": True},
          "resume": {"seconds": resume_seconds, "launches": list(resumed),
                     "latest_episode": latest},
          "saved": saved_files})

    # ---------------------------------------------------------------- checkpoint
    # every shipped checkpoint (model_weights/, converted by
    # scripts/orbax_to_torch.py) under the JAX package's batched protocol,
    # held to the JAX package's evaluation of it (jax_eval*.json, made on the
    # CPU with the same flags): july, then the gated ones; each one's
    # trained trunks through v2 and through the trunk forward kernel
    from contracts_marl_aam_corridors_tpu_torch.tools.eval_batched import run_side
    from contracts_marl_aam_corridors_tpu_torch.utils.checkpoint import arch_act_flags

    def eval_step_cost(runner, ts_):
        """One evaluation step's kernels, device ms and wall ms (the policy's
        act and the env step, the host's loop included): the difference of
        2- and 4-step evaluations of the same batch, profiled for the
        kernels and unprofiled for the wall time."""
        runs = {}
        for L in (2, 4):
            r = dataclasses.replace(runner, episode_length=L, env_params=dataclasses.replace(
                runner.env_params, episode_length=L))
            r.eval_episode(ts_, 100, EVAL_BATCH)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.eval_episode(ts_, 100, EVAL_BATCH)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PROFILE_PAUSE_S)
            with torch.profiler.profile(activities=acts) as prof:
                r.eval_episode(ts_, 100, EVAL_BATCH)
                torch.cuda.synchronize()
                time.sleep(PROFILE_PAUSE_S)
            evts = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            runs[L] = (sum(e.count for e in evts),
                       sum(e.self_device_time_total for e in evts) / 1e3, wall * 1e3)
        return {"kernels_per_step": (runs[4][0] - runs[2][0]) / 2,
                "device_ms_per_step": (runs[4][1] - runs[2][1]) / 2,
                "wall_ms_per_step": (runs[4][2] - runs[2][2]) / 2}

    def evaluate_checkpoint(label, rel_dir, jax_file, held, bars):
        """The checkpoint's 4 x 256-episode evaluation, held to its JAX
        file at ``bars``; its launches, its trained trunks (v2 against row
        1, bit for bit), a row-1 call's device ms at its evaluation's shape
        and an evaluation step's cost."""
        ckpt_dir = ROOT / rel_dir
        with open(ckpt_dir / jax_file) as f:
            jax_ref = json.load(f)
        act_flags = arch_act_flags(str(ckpt_dir))
        ck_args = parse_all(jax_ref["argv"])
        for k, v in act_flags.items():  # the run's activation flags, as the JAX side took them
            setattr(ck_args, k, v)
        ck_env, _, ck_trainer, ck_runner = cli_train.build(ck_args)
        ck_ts, ck_episode = restore_checkpoint(str(ckpt_dir), ck_trainer.init_state(SEED))
        if bars is None:
            bars = checkpoint_bars(jax_ref, held, ck_env.num_agents)
        for f in all_counters:
            f.launches = 0
        t0 = time.perf_counter()
        ck_row = run_side(ck_ts, ck_runner, n_eval=EVAL_BATCH, seeds=EVAL_SEEDS)
        torch.cuda.synchronize()
        ck_seconds = time.perf_counter() - t0
        ck_launches = [f.launches for f in all_counters]
        want = [EVAL_SEEDS * ck_env.episode_length, 0, 0, 0, 0]
        if ck_launches != want:
            raise AssertionError(f"{label}: the evaluation launched (fwd, bwd, dual fwd, dual "
                                 f"bwd, v2) {ck_launches}, expected {want}")
        if len(jax_ref["rows"]) != EVAL_SEEDS or jax_ref["rows"][0]["seed"] != 100:
            raise AssertionError(f"{label}: {jax_file} holds another protocol")
        vs_jax = {k: {"port": ck_row[k], "jax": jax_ref["mean"][k],
                      "diff": ck_row[k] - jax_ref["mean"][k], "bar": bars[k]} for k in held}
        failed = [k for k, v in vs_jax.items() if abs(v["diff"]) > v["bar"]]

        # the trained trunks on the graphs of the first eval step (seed 100)
        ck_trunks = []
        with torch.no_grad():
            _, ts0 = env_mod.reset(ck_env, EVAL_BATCH,
                                   torch.Generator(device=dev).manual_seed(100), dev)
            B, N, E = EVAL_BATCH, ck_env.num_agents, ck_env.num_entities
            nd = ts0.node_obs.reshape(B * N, E, -1)
            ad = ts0.adj[:, None].expand(B, N, E, E).reshape(B * N, E, E)
            for side in ("actor", "critic"):
                gnn = getattr(ck_ts.params, side).gnn_base
                c = gnn.cfg
                src_T, adj_T = transposed(gnn, nd, ad)
                args = trunk_args(c, E, src_T.shape[0] // E)
                got = gnn_trunk_v2.gnn_forward_v2(*args, v2_flat(gnn, c, E), src_T, adj_T)
                row1 = gnn_trunk.gnn_trunk_forward(*args, gnn.kernel_params(), src_T, adj_T)
                exact = gnn_trunk.gnn_trunk_forward_plain(
                    *args, nets._flatten_gnn_params(gnn, c.embed_layer_n, c.gnn_layer_n),
                    src_T, adj_T, compute_dtype=torch.float64)
                torch.cuda.synchronize()
                f64, _ = forward_vs_f64(got, row1, exact, E >= 20)
                # v2 runs row 1's body on the same staged floats: equal bit for bit
                ok = bool(torch.isfinite(got).all()) and torch.equal(got, row1)
                trunk = {"trunk": side, "B": B * N, "E": E, "Ds": args[1],
                         "acts": [c.embed_use_relu, c.gnn_use_relu],
                         "v2_vs_row1_max_abs_err": (got - row1).abs().max().item(),
                         "v2_vs_f64": f64["kernel_vs_f64"],
                         "row1_vs_f64": f64["plain_vs_f64"], "ok": ok}
                if side == "actor":
                    kp = gnn.kernel_params()
                    o = torch.empty((E * c.gnn_hidden_size, B * N), device=dev)
                    trunk["row1_ms"] = time_ms(torch, lambda: gnn_trunk.launch_kernel(
                        *args, kp, src_T, adj_T, o), hide_host=True)
                    v2_in = v2_flat(gnn, c, E)
                    trunk["v2_ms"] = time_ms(torch, lambda: gnn_trunk_v2.launch_v2_kernel(
                        *args, v2_in, src_T, adj_T, o), hide_host=True)
                    trunk["row1_plan"] = gnn_trunk.kernel_config(
                        E, args[1], c.gnn_num_heads, c.embed_hidden_size, c.gnn_hidden_size,
                        c.embed_layer_n, c.gnn_layer_n, B * N)
                ck_trunks.append(trunk)
        for f in all_counters:
            f.launches = 0
        step_cost = eval_step_cost(ck_runner, ck_ts)
        emit({"phase": "checkpoint", "label": label, "checkpoint": str(rel_dir),
              "jax_file": jax_file, "episode": ck_episode, "argv": jax_ref["argv"],
              "act_flags": act_flags, "agents": ck_env.num_agents, "entities": E,
              "episode_length": ck_env.episode_length, "envs": EVAL_BATCH,
              "seeds": EVAL_SEEDS, "seconds": ck_seconds,
              "wall_ms_per_step": ck_seconds * 1e3 / (EVAL_SEEDS * ck_env.episode_length),
              "step_cost": step_cost, "port": ck_row, "vs_jax": vs_jax,
              "launches": ck_launches, "trunks": ck_trunks, "jax_versions": jax_ref["versions"]})
        if failed:
            raise AssertionError(f"{label}: the port's evaluation misses the bars: {failed}")
        if not all(t["ok"] for t in ck_trunks):
            raise AssertionError(f"{label}: the trained trunks differ through v2 and row 1")
        return ck_env, ck_launches, ck_seconds

    ck_env, ck_launches, _ = evaluate_checkpoint(
        "july", JULY_CKPT, "jax_eval.json",
        ("success_rate", "all_success_rate", "gate_success_rate", "num_agent_collisions"),
        EVAL_BARS)
    ckpt_dir = ROOT / JULY_CKPT
    gated_ck = {}
    for label, rel_dir, jax_file, held in GATED_EVALS:
        _, launches_g, seconds_g = evaluate_checkpoint(label, rel_dir, jax_file, held, None)
        gated_ck[label] = {"launches": launches_g[0], "seconds": seconds_g}

    # ---------------------------------------------------------------- eval_cli
    # the eval entry point as a user runs it, on the converted checkpoint
    from contracts_marl_aam_corridors_tpu_torch.cli import eval as cli_eval

    with tempfile.TemporaryDirectory() as tmp:
        ev_argv = ["--model_dir", str(ckpt_dir), "--num_agents", str(ck_env.num_agents),
                   "--episode_length", str(ck_env.episode_length), "--render_episodes", "2",
                   "--run_dir", tmp]
        for f in all_counters:
            f.launches = 0
        t0 = time.perf_counter()
        ev_rows = cli_eval.main(ev_argv)
        torch.cuda.synchronize()
        ev_seconds = time.perf_counter() - t0
        ev_launches = [f.launches for f in all_counters]
        with open(Path(tmp) / cli_eval.CSV, newline="") as f:
            ev_csv = list(csv.DictReader(f))
    steps = ev_launches[0]
    if (list(ev_csv[0]) != JAX_EVAL_COLUMNS or len(ev_csv) != 2 or ev_launches[1:] != [0] * 4
            or not 2 <= steps <= 2 * ck_env.episode_length):
        raise AssertionError(f"cli.eval wrote columns {list(ev_csv[0])}, {len(ev_csv)} rows, "
                             f"and launched {ev_launches}")
    emit({"phase": "eval_cli", "argv": ev_argv[:1] + [str(JULY_CKPT)] + ev_argv[2:-2],
          "seconds": ev_seconds, "columns": list(ev_csv[0]), "rows": ev_rows,
          "trunk_launches": steps, "device": torch.cuda.get_device_name(0)})

    # ---------------------------------------------------------------- gated_train
    # the train entry point on three_phase, warm-started from the converted
    # rot_inv checkpoint as the shipped three_phase run was: the recipe of
    # three_phase's config.json (64 envs x 75 steps, 10 PPO epochs, one
    # minibatch, PopArt; the tanh activations adopted from the source), two
    # episodes.  The warm-started state is recorded where the CLI makes it
    # and held, bit for bit, to the CPU's warm start of the same files.
    from contracts_marl_aam_corridors_tpu_torch.utils import checkpoint as ckpt_mod

    warm_src = ROOT / WEIGHTS / "rot_inv" / "airtaxi"
    with open(ROOT / WEIGHTS / "three_phase" / "airtaxi" / "config.json") as f:
        tp_cfg = json.load(f)
    gt_argv = [f"--{k}={tp_cfg[k]}" for k in GATED_RECIPE_KEYS] + [
        "--use_popart", "--compute_dtype", "float32", "--log_interval", "1",
        "--warm_start_dir", str(warm_src),
        "--num_env_steps", str(GATED_EPISODES * GATED_STEPS * GATED_TRAIN_ENVS)]
    recorded = {}
    real_warm_start = ckpt_mod.warm_start_params

    def recording_warm_start(model_dir, ts_new, new_obs_dim):
        out = real_warm_start(model_dir, ts_new, new_obs_dim)
        recorded["state"] = {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
                             for k, v in train_state_tensors(out).items()}
        return out

    with tempfile.TemporaryDirectory() as tmp:
        ckpt_mod.warm_start_params = recording_warm_start
        gnn_trunk.gnn_trunk_forward.launches = 0
        gnn_trunk.gnn_trunk_backward.launches = 0
        try:
            t0 = time.perf_counter()
            gt_dir, gt_ts = cli_train.main(gt_argv + ["--run_dir", tmp])
            torch.cuda.synchronize()
            gt_seconds = time.perf_counter() - t0
        finally:
            ckpt_mod.warm_start_params = real_warm_start
        gt_fl, gt_bl = gnn_trunk.gnn_trunk_forward.launches, gnn_trunk.gnn_trunk_backward.launches
        with open(Path(gt_dir) / "metrics.jsonl") as f:
            gt_recs = [json.loads(line) for line in f]
        gt_saved = sorted(p.name for p in (Path(gt_dir) / "models").iterdir())
        gt_cfg = json.loads((Path(gt_dir) / "models" / "config.json").read_text())
    # per episode: actor and critic each collect step, the bootstrap
    # critic, actor and critic each epoch; the backward each epoch
    ppo = int(tp_cfg["ppo_epoch"])
    gt_want = (GATED_EPISODES * (2 * GATED_STEPS + 1 + 2 * ppo), GATED_EPISODES * 2 * ppo)
    if (gt_fl, gt_bl) != gt_want:
        raise AssertionError(f"the gated training launched the trunk kernels {(gt_fl, gt_bl)} "
                             f"times (forward, backward), expected {gt_want}")
    # the card's warm start against the CPU's, from the same files
    cpu_args = parse_all(gt_argv + ["--cuda"])
    for k, v in arch_act_flags(str(warm_src)).items():
        setattr(cpu_args, k, v)
    cpu_env, _, cpu_trainer, _ = cli_train.build(cpu_args, "cpu")
    cpu_warm = train_state_tensors(ckpt_mod.warm_start_params(
        str(warm_src), cpu_trainer.init_state(SEED), cpu_env.obs_dim))
    card_warm = recorded["state"]
    warm_keys = sorted(k for k in cpu_warm if k.split(".")[0] in ("actor", "critic", "vn"))
    differ = [k for k in warm_keys if not (
        torch.equal(card_warm[k].cpu(), cpu_warm[k]) and card_warm[k].dtype == cpu_warm[k].dtype
        if isinstance(cpu_warm[k], torch.Tensor) else card_warm[k] == cpu_warm[k])]
    fresh_adam = not any(".step" in k or "exp_avg" in k for k in card_warm)
    train_recs = [r for r in gt_recs if "value_loss" in r]
    finite = all(v == v and abs(v) != float("inf") for r in gt_recs for v in r.values())
    marks = [0.0] + [r["wall_s"] for r in train_recs]
    gt_episode_s = [b - a for a, b in zip(marks, marks[1:])]
    emit({"phase": "gated_train", "argv": gt_argv[:-4] + ["--warm_start_dir", str(
              WEIGHTS / "rot_inv" / "airtaxi")] + gt_argv[-2:],
          "episodes": GATED_EPISODES, "seconds": gt_seconds, "episode_seconds": gt_episode_s,
          "graphs_per_update_trunk_call": GATED_TRAIN_ENVS * GATED_STEPS * 3,
          "trunk_launches": {"forward": gt_fl, "backward": gt_bl, "expected": list(gt_want)},
          "warm_start": {"tensors_and_values": len(warm_keys), "differ_from_cpu": differ,
                         "adam_fresh": fresh_adam,
                         "act_flags": [gt_cfg["use_ReLU"], gt_cfg["embed_use_ReLU"],
                                       gt_cfg["gnn_use_ReLU"]]},
          "last_episode": {k: train_recs[-1][k] for k in (
              "average_episode_rewards", "value_loss", "policy_loss", "env_steps_per_sec")},
          "saved": gt_saved})
    if differ or not fresh_adam or len(warm_keys) == 0:
        raise AssertionError(f"the card's warm start differs from the CPU's: {differ[:5]}, "
                             f"fresh Adam {fresh_adam}")
    if len(train_recs) != GATED_EPISODES or not finite or "ckpt_0" not in gt_saved:
        raise AssertionError(f"the gated training logged {len(train_recs)} episodes (finite "
                             f"{finite}) and saved {gt_saved}")
    if any(gt_cfg[k] for k in ("use_ReLU", "embed_use_ReLU", "gnn_use_ReLU")):
        raise AssertionError("the gated training did not adopt the source's tanh activations")

    # ---------------------------------------------------------------- env_card
    # the env of this slice on the card against the CPU: one port reset per
    # pair made on the CPU and moved to the card, the same numpy actions on
    # both; obs, node_obs and adj held where no env reset, reward and done
    # everywhere.  The last step hits the time limit and auto-resets every
    # env from each device's own generator, so the fresh episodes differ;
    # v4oct's frozen_pos must come through the reset unchanged on both.
    # Nothing else of these paths draws (v4oct never freezes an agent, the
    # double integrator's freeze zeroes its velocity).
    import numpy as np

    from contracts_marl_aam_corridors_tpu_torch.config.physics import DynamicsType
    from contracts_marl_aam_corridors_tpu_torch.envs import dynamics as dyn_mod

    to_dev = lambda st: map_state(lambda x: x.to(dev), st)
    cpu = torch.device("cpu")

    def env_card_run(p_, veh):
        """ENV_CARD_ENVS envs of ``p_`` in float64 through ENV_CARD_STEPS
        steps on the card and on the CPU from one CPU reset, the same numpy
        actions on both: obs, node_obs and adj held where no env reset and
        no agent froze with a drawn heading, reward, done and both collision
        counters everywhere.  A heading model's freeze draws the heading
        from each device's own generator, so the card then goes on from the
        CPU's state, as after an early reset."""
        g_c = torch.Generator().manual_seed(SEED + 11)
        g_d = torch.Generator(device=dev).manual_seed(SEED + 11)
        s_c, _ = env_mod.reset(p_, ENV_CARD_ENVS, g_c, cpu, torch.float64)
        s_d = to_dev(s_c)
        rng = np.random.RandomState(SEED + 11)
        err = dict.fromkeys(("obs", "node_obs", "adj", "reward"), 0.0)
        done_equal, counters_equal, early_resets, resynced = True, True, 0, 0
        draws = p_.cfg.dynamics != DynamicsType.DOUBLE_INTEGRATOR
        t0 = time.perf_counter()
        for t in range(ENV_CARD_STEPS):
            act = torch.as_tensor(rng.randint(0, p_.num_actions, (ENV_CARD_ENVS, p_.num_agents)))
            before_c, before_d = s_c, s_d
            s_d, ts_d = env_mod.step(p_, s_d, act.to(dev), g_d)
            s_c, ts_c = env_mod.step(p_, s_c, act, g_c)
            reset = ts_c.done.all(dim=1)
            froze = ((s_c.status & ~before_c.status).any(dim=1) & ~reset if draws
                     else torch.zeros_like(reset))
            done_equal &= torch.equal(ts_d.done.cpu(), ts_c.done)
            for k in ("Num_agent_collisions", "Num_obst_collisions"):
                counters_equal &= torch.equal(ts_d.info[k].cpu(), ts_c.info[k])
            for k in err:
                a, b = getattr(ts_d, k).cpu(), getattr(ts_c, k)
                if k != "reward":
                    a, b = a[~(reset | froze)], b[~(reset | froze)]
                if a.numel():
                    err[k] = max(err[k], (a - b).abs().max().item())
            if froze.any() or (reset.any() and t < ENV_CARD_STEPS - 1):
                early_resets += int(bool(reset.any()) and t < ENV_CARD_STEPS - 1)
                resynced += int(froze.sum())
                s_d = to_dev(s_c)  # go on from the CPU's draw
        torch.cuda.synchronize()
        pair_s = time.perf_counter() - t0
        frozen_kept = s_c.frozen_pos is None or (
            torch.equal(s_c.frozen_pos, before_c.frozen_pos)
            and torch.equal(s_d.frozen_pos, before_d.frozen_pos)
            and torch.equal(s_d.frozen_pos.cpu(), s_c.frozen_pos))
        fresh = bool(reset.all()) and bool((s_c.t == 0).all()) and bool((s_d.t == 0).all())
        ok = (done_equal and counters_equal and max(err.values()) <= ENV_TOL and frozen_kept
              and fresh)
        return {"scenario": p_.scenario, "vehicle": veh,
                "agents": p_.num_agents, "obstacles": p_.num_obstacles, "walls": p_.num_walls,
                "entities": p_.num_entities, "envs": ENV_CARD_ENVS, "steps": ENV_CARD_STEPS,
                "max_abs_err": err, "done_equal": done_equal,
                "collision_counters_equal": counters_equal,
                # the last step's counts: the whole episode's, every env
                "obstacle_collisions": ts_c.info["Num_obst_collisions"].sum().item(),
                "early_resets": early_resets, "envs_resynced_after_a_drawn_freeze": resynced,
                "auto_reset_all": fresh, "frozen_pos_kept": frozen_kept,
                "seconds_card_and_cpu": pair_s, "ok": ok}

    t_phase = time.perf_counter()
    env_rows = [env_card_run(EnvParams(cfg=vehicle_config(veh), scenario=scen,
                                       episode_length=ENV_CARD_STEPS), veh)
                for scen, veh in ENV_CARD_PAIRS]
    env_card_s = time.perf_counter() - t_phase
    emit({"phase": "env_card", "tol": ENV_TOL, "pairs": env_rows, "phase_seconds": env_card_s})
    if not all(r["ok"] for r in env_rows):
        raise AssertionError(f"the card's env differs from the CPU's: "
                             f"{[r for r in env_rows if not r['ok']]}")

    # ---------------------------------------------------------------- rk45_card
    # scipy's RK45 replica at 4,096 states of each vehicle, card against CPU
    # in float64: the states before and after the clamp, and how many
    # states took a different number of accepted steps on the two devices
    t_phase = time.perf_counter()
    rk_rows = []
    for veh in ("air_taxi", "unicycle_vehicle", "double_integrator"):
        vc = vehicle_config(veh)
        g = torch.Generator().manual_seed(SEED + 12)
        u = lambda *shape: torch.rand(shape, generator=g, dtype=torch.float64)
        lo_hi = lambda lo, hi, *shape: lo + (hi - lo) * u(*shape)
        n = RK45_STATES
        # the ranges of the rk45 tests, controls with the decoder's x5
        if veh == "double_integrator":
            y0 = lo_hi(-2, 2, n, 4)
            a = lo_hi(vc.accel_min, vc.accel_max, n, 2) * 5
        else:
            y0 = torch.stack([lo_hi(-2, 2, n), lo_hi(-2, 2, n), lo_hi(-math.pi, math.pi, n),
                              lo_hi(vc.v_min, vc.v_max, n)], dim=-1)
            a = torch.stack([lo_hi(-vc.angular_rate_max, vc.angular_rate_max, n) * 5,
                             lo_hi(vc.accel_min, vc.accel_max, n) * 5], dim=-1)
        y0_d, a_d = y0.to(dev), a.to(dev)
        dyn_mod.rk45_solve(y0_d, a_d, vc.dt, vc.dynamics)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_d, n_d = dyn_mod.rk45_solve(y0_d, a_d, vc.dt, vc.dynamics)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        y_c, n_c = dyn_mod.rk45_solve(y0, a, vc.dt, vc.dynamics)
        st_d, st_c = dyn_mod.step_rk45(y0_d, a_d, vc), dyn_mod.step_rk45(y0, a, vc)
        max_err = max((y_d.cpu() - y_c).abs().max().item(), (st_d.cpu() - st_c).abs().max().item())
        steps_differ = int((n_d.cpu() != n_c).sum())
        rk_rows.append({
            "vehicle": veh, "states": n, "max_abs_err": max_err,
            "states_with_other_step_counts": steps_differ,
            "accepted_steps_min_max": [int(n_c.min()), int(n_c.max())],
            "closed_form_vs_rk45_max_abs": (dyn_mod.step_closed_form(y0, a, vc)
                                            - st_c).abs().max().item(),
            "card_wall_ms": card_ms, "ok": max_err <= ENV_TOL})
    rk45_s = time.perf_counter() - t_phase
    emit({"phase": "rk45_card", "tol": ENV_TOL, "vehicles": rk_rows, "phase_seconds": rk45_s})
    if not all(r["ok"] for r in rk_rows):
        raise AssertionError(f"the card's rk45 differs from the CPU's: {rk_rows}")

    # ---------------------------------------------------------------- v4oct_train
    # the train entry point on v4oct with the double integrator (the
    # launcher's 25-step episode) at the default model's full width: two
    # episodes of TRAIN_ENVS envs, every trunk call through rows 1 and 2;
    # then, from the trained state, a rollout step at N_ENVS envs and an
    # update epoch profiled as the rollout and train phases profile july's,
    # and one update card (kernels) against CPU (plain versions)
    t_phase = time.perf_counter()
    v4_argv = ["--scenario_name", V4OCT, "--dynamics_type", "double_integrator",
               "--episode_length", str(STEPS), "--num_agents", str(ep.num_agents),
               "--n_rollout_threads", str(TRAIN_ENVS), "--ppo_epoch", str(PPO_EPOCH),
               "--num_mini_batch", "1", "--data_chunk_length", str(CHUNK), "--log_interval",
               "1", "--seed", str(SEED), "--compute_dtype", "float32",
               "--num_env_steps", str(V4OCT_EPISODES * STEPS * TRAIN_ENVS)]
    with tempfile.TemporaryDirectory() as v4_tmp:
        for f in all_counters:
            f.launches = 0
        t0 = time.perf_counter()
        v4_dir, v4_ts = cli_train.main(v4_argv + ["--run_dir", v4_tmp])
        torch.cuda.synchronize()
        v4_seconds = time.perf_counter() - t0
        v4_launches = [f.launches for f in all_counters]
        v4_want = [V4OCT_EPISODES * fwd_expected, V4OCT_EPISODES * bwd_expected, 0, 0, 0]
        if v4_launches != v4_want:
            raise AssertionError(f"the v4oct training launched (fwd, bwd, dual fwd, dual bwd, "
                                 f"v2) {v4_launches}, expected {v4_want}")
        with open(Path(v4_dir) / "metrics.jsonl") as f:
            v4_recs = [json.loads(line) for line in f]
        v4_train_recs = [r for r in v4_recs if "value_loss" in r]
        if len(v4_train_recs) != V4OCT_EPISODES or not all(
                v == v and abs(v) != float("inf") for r in v4_recs for v in r.values()):
            raise AssertionError(f"the v4oct training logged {v4_recs}")
        v4_cfg = json.loads((Path(v4_dir) / "models" / "config.json").read_text())

        v4_env, _, _, v4_runner = cli_train.build(parse_all(v4_argv))
        roll = dataclasses.replace(v4_runner, n_rollout_threads=N_ENVS)
        dataclasses.replace(roll, episode_length=2).collect(v4_ts, roll.init_carry(SEED + 3))
        c0 = roll.init_carry(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, v4_buf, _ = roll.collect(v4_ts, c0)
        torch.cuda.synchronize()
        v4_collect_s = time.perf_counter() - t0
        for k in ("obs", "node_obs", "adj", "rewards", "value_preds", "returns"):
            if not torch.isfinite(getattr(v4_buf, k)).all():
                raise AssertionError(f"v4oct buffer {k} is not finite")
        v4_profile = collect_profile(roll, v4_ts, SEED + 4, v4_collect_s)
        v4_update, _ = update_profile_of(v4_runner, v4_ts, v4_runner.init_carry(SEED + 6))
        v4_ratio, v4_grad_err, v4_infos = update_card_vs_cpu(v4_env)
        v4_train_s = time.perf_counter() - t_phase
        emit({"phase": "v4oct_train", "argv": v4_argv, "episodes": V4OCT_EPISODES,
              "seconds": v4_seconds,
              "episode_seconds": [b - a for a, b in zip(
                  [0.0] + [r["wall_s"] for r in v4_train_recs[:-1]],
                  [r["wall_s"] for r in v4_train_recs])],
              "trunk_launches": {"forward": v4_launches[0], "backward": v4_launches[1],
                                 "expected": v4_want[:2]},
              "recorded": {k: v4_cfg[k] for k in ("scenario_name", "dynamics_type",
                                                  "episode_length", "total_actions")},
              "num_actions": v4_env.num_actions,
              "last_episode": {k: v4_train_recs[-1][k] for k in (
                  "average_episode_rewards", "value_loss", "policy_loss", "env_steps_per_sec")},
              "rollout": {"envs": N_ENVS, "steps": STEPS, "collect_seconds": v4_collect_s,
                          "wall_ms_per_step": v4_collect_s * 1e3 / STEPS,
                          "env_steps_per_s": N_ENVS * STEPS / v4_collect_s,
                          "profile": v4_profile},
              "update_profile": v4_update,
              "july_beside": {"rollout_wall_ms_per_step": seconds * 1e3 / STEPS,
                              "rollout_profile": profile, "update_profile": update_profile},
              "card_vs_cpu": {"envs": CMP_ENVS, "first_epoch_grad_worst_ratio_to_bar": v4_ratio,
                              "first_epoch_grad_max_abs_err": v4_grad_err,
                              "train_info_card": v4_infos["card"],
                              "train_info_cpu": v4_infos["cpu"]},
              "phase_seconds": v4_train_s})

        # ------------------------------------------------------------ v4oct_eval
        # the eval entry point on the checkpoint the v4oct training wrote
        t_phase = time.perf_counter()
        v4_ev_argv = ["--model_dir", str(Path(v4_dir) / "models"), "--scenario_name", V4OCT,
                      "--num_agents", str(ep.num_agents), "--episode_length", str(STEPS),
                      "--render_episodes", "2", "--run_dir", str(Path(v4_tmp) / "eval")]
        for f in all_counters:
            f.launches = 0
        v4_rows = cli_eval.main(v4_ev_argv)
        torch.cuda.synchronize()
        v4_ev_launches = [f.launches for f in all_counters]
        v4_eval_s = time.perf_counter() - t_phase
    finite = all(v == v and abs(v) != float("inf") for r in v4_rows for v in r.values())
    emit({"phase": "v4oct_eval", "argv": ["--model_dir", "<v4oct_train's models>"]
          + v4_ev_argv[2:-2], "rows": v4_rows, "finite": finite,
          "trunk_launches": v4_ev_launches, "phase_seconds": v4_eval_s})
    # v4oct's agents never freeze, so each episode runs to its time limit:
    # one row-1 launch a step, render episodes x episode length in all
    if (len(v4_rows) != 2 or not finite or v4_ev_launches[1:] != [0] * 4
            or v4_ev_launches[0] != 2 * STEPS):
        raise AssertionError(f"cli.eval on the v4oct checkpoint gave {len(v4_rows)} rows "
                             f"(finite {finite}) and launched {v4_ev_launches}")

    # ---------------------------------------------------------------- walls_env_card
    # the obstacle and wall envs on the card against the CPU, as env_card
    t_phase = time.perf_counter()
    walls_env_rows = [env_card_run(EnvParams(cfg=vehicle_config(veh), scenario=scen,
                                             episode_length=ENV_CARD_STEPS, **kw), veh)
                      for scen, veh, kw in WALLS_ENV_CARD]
    emit({"phase": "walls_env_card", "tol": ENV_TOL, "configs": walls_env_rows,
          "phase_seconds": time.perf_counter() - t_phase})
    if not all(r["ok"] for r in walls_env_rows):
        raise AssertionError(f"the card's obstacle and wall env differs from the CPU's: "
                             f"{[r for r in walls_env_rows if not r['ok']]}")

    # ---------------------------------------------------------------- walls_trunk
    # rows 1 and 2 at the graphs of the two configurations: E = 13, Ds = 9
    # and E = 22, Ds = 14, weights of a GNNBase of their width, random graphs
    # with every entity type; row 1 at 3,072 and 64,000 graphs, row 2 at the
    # update's graphs, each at the bars of the kernel and backward phases,
    # launched twice for identical bits, resident >= planned CTAs an SM
    def trunk_graphs(B, E, F, seed):
        g_ = torch.Generator(device=dev).manual_seed(seed)
        node, adj = random_graphs(B, E, cfg.max_edge_dist, g_, F)
        node[..., -1] = torch.randint(0, 4, (B, E), generator=g_, device=dev).float()
        return node, adj

    def forward_check(gnn, c, nd, ad, tol):
        """Row 1 against its plain version (and float64) on one batch, with
        its plan and device ms beside its bound and the plain version's."""
        src_T, adj_T = transposed(gnn, nd, ad)
        E, B = nd.shape[1], nd.shape[0]
        args = trunk_args(c, E, src_T.shape[0] // E)
        flat = nets._flatten_gnn_params(gnn, c.embed_layer_n, c.gnn_layer_n)
        kp = gnn.kernel_params()
        got = gnn_trunk.gnn_trunk_forward(*args, kp, src_T, adj_T)
        identical = torch.equal(got, gnn_trunk.gnn_trunk_forward(*args, kp, src_T, adj_T))
        want = gnn_trunk.gnn_trunk_forward_plain(*args, flat, src_T, adj_T)
        exact = gnn_trunk.gnn_trunk_forward_plain(*args, flat, src_T, adj_T,
                                                  compute_dtype=torch.float64)
        torch.cuda.synchronize()
        f64, f64_ok = forward_vs_f64(got, want, exact, tol is WIDE_TOL)
        conf = forward_plan(c, E, args[1], B)
        ok = (bool(torch.isfinite(got).all()) and torch.allclose(got, want, **tol) and f64_ok
              and identical and conf["ctas_per_sm"] >= conf["planned_ctas_per_sm"])
        edges = int(((adj_T > 0) & (adj_T < c.max_edge_dist)).sum().item())
        w = gnn_trunk.trunk_work(E, args[1], args[2], kp.F1, args[3], c.embed_layer_n,
                                 c.gnn_layer_n, B, edges, kp.blob.numel())
        b_ms, b_by = bound(w)
        o = torch.empty_like(got)
        row = {"row": 1, "E": E, "Ds": args[1], "B": B,
               "max_abs_err": (got - want).abs().max().item(), **tol, **f64,
               "two_launches_identical": identical, "ok": ok, **conf,
               "ms": time_ms(torch, lambda: gnn_trunk.launch_kernel(*args, kp, src_T, adj_T, o),
                             reps=10, hide_host=True),
               "plain_ms": time_ms(torch, lambda: gnn_trunk.gnn_trunk_forward_plain(
                   *args, flat, src_T, adj_T), reps=3, warmup=1),
               "bound_ms": b_ms, "bound_by": b_by, "flops": w["flops"], "bytes": w["bytes"],
               "edges": edges}
        del got, want, exact, o
        return row

    def backward_check(gnn, c, nd, ad):
        """Row 2 against its plain version (and float64) on one batch, relu
        graphs near zero set aside, with its plan, registers, local memory
        and device ms beside its bound and the plain version's."""
        src_T, adj_T = transposed(gnn, nd, ad)
        E, B = nd.shape[1], nd.shape[0]
        Ds = src_T.shape[0] // E
        args = trunk_args(c, E, Ds)
        g = torch.randn((E * c.gnn_hidden_size, B), generator=gen, device=dev)
        kp = gnn.kernel_params()
        flat = gnn_trunk.unpack_blob(kp, Ds, c.gnn_num_heads, c.gnn_hidden_size,
                                     c.embed_layer_n, c.gnn_layer_n)
        aside = set_aside_relu_flips(c, args, [(flat, src_T)], adj_T, [g])
        first = gnn_trunk.gnn_trunk_backward(*args, kp, src_T, adj_T, g)
        identical = all(torch.equal(a, b) for a, b in zip(
            first, gnn_trunk.gnn_trunk_backward(*args, kp, src_T, adj_T, g)))
        got = grad_leaves(c, Ds, *first)
        dflat, ds, da = gnn_trunk.gnn_trunk_backward_plain(*args, flat, src_T, adj_T, g)
        want = list(dflat) + [ds, da]
        del dflat, ds, da
        torch.cuda.empty_cache()
        # float64 in chunks of graphs (its autograd graph at 128,000 graphs
        # and E = 13 does not fit the card whole), the parameter gradients
        # summed over them
        parts = [gnn_trunk.gnn_trunk_backward_plain(
            *args, flat, src_T[:, i:i + F64_CHUNK], adj_T[:, i:i + F64_CHUNK],
            g[:, i:i + F64_CHUNK], compute_dtype=torch.float64) for i in range(0, B, F64_CHUNK)]
        exact = [sum(p[0][k] for p in parts) for k in range(len(parts[0][0]))] + [
            torch.cat([p[j] for p in parts], dim=1) for j in (1, 2)]
        del parts
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        rows = compare_leaves(got, want, exact)
        conf = gnn_trunk.backward_config(E, Ds, args[2], c.embed_hidden_size, args[3],
                                         c.embed_layer_n, c.gnn_layer_n, B)
        conf.update(gnn_trunk.backward_attributes(E, Ds, args[2], c.embed_hidden_size, args[3],
                                                  c.embed_layer_n, c.gnn_layer_n))
        ok = (finite and identical and all(r["ok"] for r in rows)
              and conf["ctas_per_sm"] >= conf["planned_ctas_per_sm"])
        worst = max(rows, key=lambda r: r["max_abs_err"] / r["bar"])
        del first, got, want, exact
        torch.cuda.empty_cache()
        bufs = (torch.empty_like(src_T), torch.empty_like(adj_T), torch.empty_like(kp.blob),
                torch.empty((conf["ctas"], kp.blob.numel()), device=dev))
        edges = int(((adj_T > 0) & (adj_T < c.max_edge_dist)).sum().item())
        bw = gnn_trunk.trunk_bwd_work(E, Ds, args[2], kp.F1, args[3], c.embed_layer_n,
                                      c.gnn_layer_n, B, edges, kp.blob.numel())
        b_ms, b_by = bound(bw)
        row = {"row": 2, "E": E, "Ds": Ds, "B": B, "acts": [c.embed_use_relu, c.gnn_use_relu],
               "max_abs_err": max(r["max_abs_err"] for r in rows), "finite": finite,
               "two_launches_identical": identical, "ok": ok,
               "relu_graphs_set_aside": int(aside.sum().item()),
               "worst_leaf": rows.index(worst), **worst, **conf,
               "leaves": rows if not ok else len(rows),
               "ms": time_ms(torch, lambda: gnn_trunk.launch_backward_kernel(
                   *args, kp, src_T, adj_T, g, *bufs), reps=5, hide_host=True),
               "plain_ms": time_ms(torch, lambda: gnn_trunk.gnn_trunk_backward_plain(
                   *args, flat, src_T, adj_T, g), reps=2, warmup=1),
               "bound_ms": b_ms, "bound_by": b_by, "flops": bw["flops"], "bytes": bw["bytes"],
               "edges": edges}
        del bufs, g
        torch.cuda.empty_cache()
        return row

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    walls_trunk = []
    with torch.no_grad():
        for E, F, upd in ((13, 8, TRAIN_ENVS * STEPS * OBST_ENV["num_agents"]),
                          (22, 13, WALL_ENVS * STEPS * WALL_ENV["num_agents"])):
            shape_gnn = {}
            for c in (cfg, tcfg):
                m = nets.GNNBase(c, F, "node")
                m.init_(torch.Generator().manual_seed(SEED + 13))
                shape_gnn[c.gnn_use_relu] = m.to(dev)
            tol = KERNEL_TOL if E <= 13 else WIDE_TOL
            for B in (3072, 64000):
                nd, ad = trunk_graphs(B, E, F, SEED + 14)
                walls_trunk.append(forward_check(shape_gnn[True], cfg, nd, ad, tol))
            nd, ad = trunk_graphs(upd, E, F, SEED + 15)
            for c in (cfg, tcfg):
                walls_trunk.append(backward_check(shape_gnn[c.gnn_use_relu], c, nd, ad))
            del nd, ad
            torch.cuda.empty_cache()
    emit({"phase": "walls_trunk", "checks": walls_trunk,
          "ptxas": {k: built[k]["ptxas"] for k in ("gnn_trunk_fwd", "gnn_trunk_bwd")},
          "phase_seconds": time.perf_counter() - t_phase})
    if not all(r["ok"] for r in walls_trunk):
        raise AssertionError(f"rows 1 and 2 disagree at the obstacle and wall shapes: "
                             f"{[(r['row'], r['E'], r['B']) for r in walls_trunk if not r['ok']]}")

    # ---------------------------------------------------------------- obstacles_train, walls_train
    # the train entry point on each configuration at the default model's
    # full width: two episodes, every trunk call through rows 1 and 2 (as
    # many launches as two flagship episodes), the last checkpoint restored
    # bit for bit; an update profiled as the train phase's, one update card
    # (kernels) against CPU (plain versions); config 2's rollout step at
    # N_ENVS envs profiled as the rollout phase's.  Then the eval entry
    # point on the checkpoint, its obstacle collisions recorded inside the
    # CLI by wrapping the env step.
    def env_argv(kw):
        return [a for k, v in kw.items() for a in (f"--{k}", str(v))]

    def train_and_eval(label, argv, n_envs, cmp_envs, eval_argv, rollout_step, case=None,
                       compare=None, profile=True, extra=None, episodes=WALLS_EPISODES,
                       kernel_route=True, compare_key="card_vs_cpu"):
        """The train CLI on ``argv`` (``episodes`` episodes), then the eval
        CLI on its checkpoint.  ``kernel_route``: every trunk call through
        rows 1 and 2, else (the dense GNN) none, by the wrappers' counts and
        by the profiled update's kernel names."""
        compare = compare or update_card_vs_cpu
        label_ = label if case is None else f"{label} ({case})"
        t_train = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp_:
            for f in all_counters:
                f.launches = 0
            t0 = time.perf_counter()
            run_dir_, ts_ = cli_train.main(argv + ["--run_dir", tmp_])
            torch.cuda.synchronize()
            seconds_ = time.perf_counter() - t0
            got_launches = [f.launches for f in all_counters]
            want_launches = ([episodes * fwd_expected, episodes * bwd_expected, 0, 0, 0]
                             if kernel_route else [0] * 5)
            if got_launches != want_launches:
                raise AssertionError(f"{label_}: the training launched (fwd, bwd, dual fwd, dual "
                                     f"bwd, v2) {got_launches}, expected {want_launches}")
            with open(Path(run_dir_) / "metrics.jsonl") as f:
                recs = [json.loads(line) for line in f]
            train_recs_ = [r for r in recs if "value_loss" in r]
            if len(train_recs_) != episodes or not all(
                    v == v and abs(v) != float("inf") for r in recs for v in r.values()):
                raise AssertionError(f"{label_}: the training logged {recs}")
            models_ = Path(run_dir_) / "models"
            env_, _, trainer_, runner_ = cli_train.build(parse_all(argv))
            restored_, saved_ = restore_checkpoint(str(models_), trainer_.init_state(SEED + 99))
            held_, back_ = train_state_tensors(ts_), train_state_tensors(restored_)
            differ_ = sorted(k for k, v in held_.items() if not (
                torch.equal(back_[k], v) and back_[k].dtype == v.dtype
                and back_[k].device == v.device
                if isinstance(v, torch.Tensor) else back_.get(k) == v))
            if saved_ != episodes - 1 or set(back_) != set(held_) or differ_:
                raise AssertionError(f"{label_}: the checkpoint of episode {saved_} does not "
                                     f"restore bit for bit: {differ_[:5]}")
            out = {"case": case, "argv": argv, "envs": n_envs, "episodes": episodes,
                   "entities": env_.num_entities, "node_feat_dim": env_.node_feat_dim,
                   "graphs_per_update_trunk_call": n_envs * STEPS * env_.num_agents,
                   "seconds": seconds_,
                   "episode_seconds": [b - a for a, b in zip(
                       [0.0] + [r["wall_s"] for r in train_recs_[:-1]],
                       [r["wall_s"] for r in train_recs_])],
                   "trunk_launches": {"forward": got_launches[0], "backward": got_launches[1],
                                      "expected": want_launches[:2],
                                      "dual_forward": got_launches[2],
                                      "dual_backward": got_launches[3], "v2": got_launches[4]},
                   "restore": {"episode": saved_, "tensors_and_values": len(held_),
                               "bit_for_bit": True},
                   "last_episode": {k: train_recs_[-1][k] for k in (
                       "average_episode_rewards", "value_loss", "policy_loss",
                       "env_steps_per_sec")}}
            if rollout_step:
                roll = dataclasses.replace(runner_, n_rollout_threads=N_ENVS)
                dataclasses.replace(roll, episode_length=2).collect(ts_, roll.init_carry(SEED + 3))
                c0_ = roll.init_carry(SEED)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, rbuf, _ = roll.collect(ts_, c0_)
                torch.cuda.synchronize()
                collect_s = time.perf_counter() - t0
                for k in ("obs", "node_obs", "adj", "rewards", "value_preds", "returns"):
                    if not torch.isfinite(getattr(rbuf, k)).all():
                        raise AssertionError(f"{label_}: buffer {k} is not finite")
                del rbuf
                out["rollout"] = {"envs": N_ENVS, "steps": STEPS, "collect_seconds": collect_s,
                                  "wall_ms_per_step": collect_s * 1e3 / STEPS,
                                  "env_steps_per_s": N_ENVS * STEPS / collect_s,
                                  "profile": collect_profile(roll, ts_, SEED + 4, collect_s)}
            if profile:
                out["update_profile"], _ = update_profile_of(runner_, ts_,
                                                             runner_.init_carry(SEED + 6))
                if not kernel_route and out["update_profile"]["trunk_kernel_launches"]:
                    raise AssertionError(f"{label_}: the profiled update ran trunk kernels")
            ratio_, grad_err_, infos_ = compare(env_, cmp_envs, hj_data=runner_.hj_data,
                                                use_centralized_v=runner_.use_centralized_v)
            out[compare_key] = {"envs": cmp_envs, "first_epoch_grad_worst_ratio_to_bar": ratio_,
                                "first_epoch_grad_max_abs_err": grad_err_,
                                **{f"train_info_{k}": v for k, v in infos_.items()}}
            out.update(extra or {})
            out["phase_seconds"] = time.perf_counter() - t_train
            emit({"phase": f"{label}_train", **out})

            # the eval entry point on the checkpoint this training wrote
            t_eval = time.perf_counter()
            ev_argv_ = ["--model_dir", str(models_)] + eval_argv + [
                "--episode_length", str(STEPS), "--render_episodes", "2",
                "--run_dir", str(Path(tmp_) / "eval")]
            episodes_obst, ev_steps = [], []
            real_reset, real_step = env_mod.reset, env_mod.step

            def counting_reset(*a, **k):
                episodes_obst.append(0.0)
                return real_reset(*a, **k)

            def counting_step(*a, **k):
                st_, ts_step = real_step(*a, **k)
                episodes_obst[-1] = ts_step.info["Num_obst_collisions"].sum().item()
                ev_steps.append(1)
                return st_, ts_step

            for f in all_counters:
                f.launches = 0
            env_mod.reset, env_mod.step = counting_reset, counting_step
            t0 = time.perf_counter()
            try:
                ev_rows_ = cli_eval.main(ev_argv_)
            finally:
                env_mod.reset, env_mod.step = real_reset, real_step
            torch.cuda.synchronize()
            ev_seconds = time.perf_counter() - t0
            ev_launches_ = [f.launches for f in all_counters]
        finite_ = all(v == v and abs(v) != float("inf") for r in ev_rows_ for v in r.values())
        emit({"phase": f"{label}_eval", "case": case,
              "argv": ["--model_dir", f"<{label}_train's models>"] + ev_argv_[2:-2],
              "rows": ev_rows_, "finite": finite_,
              "num_obst_collisions_per_episode": episodes_obst, "trunk_launches": ev_launches_,
              "eval_seconds": ev_seconds, "eval_steps": len(ev_steps),
              "wall_ms_per_step": ev_seconds * 1e3 / max(len(ev_steps), 1),
              "phase_seconds": time.perf_counter() - t_eval})
        # one row-1 launch a step until every agent is done or the time
        # limit on the kernel trunk, none on the dense GNN
        row1_ok = (2 <= ev_launches_[0] <= 2 * STEPS if kernel_route
                   else ev_launches_[0] == 0)
        if (len(ev_rows_) != 2 or not finite_ or ev_launches_[1:] != [0] * 4
                or not row1_ok or len(episodes_obst) != 2):
            raise AssertionError(f"{label_}: cli.eval gave {len(ev_rows_)} rows (finite "
                                 f"{finite_}), {len(episodes_obst)} episodes and launched "
                                 f"{ev_launches_}")
        return out, ev_launches_

    common = ["--episode_length", str(STEPS), "--ppo_epoch", str(PPO_EPOCH), "--num_mini_batch",
              "1", "--data_chunk_length", str(CHUNK), "--log_interval", "1", "--seed", str(SEED),
              "--compute_dtype", "float32"]
    obst_argv = common + env_argv(OBST_ENV) + [
        "--dynamics_type", "air_taxi", "--n_rollout_threads", str(TRAIN_ENVS),
        "--num_env_steps", str(WALLS_EPISODES * STEPS * TRAIN_ENVS)]
    obst_out, obst_ev = train_and_eval(
        "obstacles", obst_argv, TRAIN_ENVS, OBST_CMP_ENVS,
        env_argv({k: v for k, v in OBST_ENV.items() if k != "world_size"}), True)
    wall_argv = common + env_argv(WALL_ENV) + [
        "--dynamics_type", "double_integrator", "--n_rollout_threads", str(WALL_ENVS),
        "--num_env_steps", str(WALLS_EPISODES * STEPS * WALL_ENVS)]
    wall_out, wall_ev = train_and_eval(
        "walls", wall_argv, WALL_ENVS, WALL_CMP_ENVS,
        env_argv({k: v for k, v in WALL_ENV.items() if k in ("num_agents", "num_landmarks")}),
        False)

    # ---------------------------------------------------------------- formations_env_card
    from contracts_marl_aam_corridors_tpu_torch.envs import corridor as corridor_mod
    from contracts_marl_aam_corridors_tpu_torch.envs import reset as reset_mod
    from contracts_marl_aam_corridors_tpu_torch.envs import tube as tube_mod

    def formation_env_card_run(scen, veh, formation):
        """ENV_CARD_ENVS envs of ``formation``, env k from the numpy parity
        reset after np.random.seed(k), with the fixed freeze heading, through
        FORMATION_STEPS steps on the card and on the CPU with the same numpy
        actions and no re-sync at a freeze: obs, node_obs, adj and the agent
        states held where no env reset, reward, done and both collision
        counters everywhere.  In the first FORMATION_PLACED envs that have
        one, an agent whose goal lies past the tube starts beside it in
        phase 2, so that agents freeze; an env whose agents are all done
        before the time limit resets from each device's generator and is
        then re-synced from the CPU (counted)."""
        p_ = EnvParams(cfg=vehicle_config(veh), scenario=scen, formation_type=formation,
                       episode_length=FORMATION_STEPS, parity_fixed_reset_theta=FIXED_THETA)
        t0 = time.perf_counter()
        resets = []
        for k in range(ENV_CARD_ENVS):
            np.random.seed(k)
            resets.append(reset_mod.reset_parity_numpy(p_))
        s_c = map_state(lambda *xs: torch.cat(xs), *resets)
        reset_s = time.perf_counter() - t0
        placed = 0
        if scen != "v4oct":
            goals = corridor_mod.goal_positions(s_c.landmark_pos, s_c.goal_match)
            past = tube_mod.passed_tube(s_c.tube, goals)
            for b in torch.nonzero(past.any(dim=1))[:FORMATION_PLACED, 0].tolist():
                i = int(torch.nonzero(past[b])[-1])
                s_c.agent_states[b, i, :2] = goals[b, i] + torch.tensor([0.01, -0.005],
                                                                         dtype=torch.float64)
                s_c.prev_phase[b, i] = s_c.phase_reached[b, i] = 2
                placed += 1
        s_d = to_dev(s_c)
        g_c = torch.Generator().manual_seed(SEED + 13)
        g_d = torch.Generator(device=dev).manual_seed(SEED + 13)
        acts = np.random.RandomState(SEED + 13).randint(
            0, p_.num_actions, (FORMATION_STEPS, ENV_CARD_ENVS, p_.num_agents))
        err = dict.fromkeys(("obs", "node_obs", "adj", "agent_states", "reward"), 0.0)
        done_equal, counters_equal, freezes, early_resets = True, True, 0, 0
        t0 = time.perf_counter()
        for t in range(FORMATION_STEPS):
            act = torch.as_tensor(acts[t])
            status = s_c.status.clone()
            s_d, ts_d = env_mod.step(p_, s_d, act.to(dev), g_d)
            s_c, ts_c = env_mod.step(p_, s_c, act, g_c)
            reset = ts_c.done.all(dim=1)
            freezes += int((s_c.status & ~status)[~reset].sum())
            done_equal &= torch.equal(ts_d.done.cpu(), ts_c.done)
            for k in ("Num_agent_collisions", "Num_obst_collisions"):
                counters_equal &= torch.equal(ts_d.info[k].cpu(), ts_c.info[k])
            for k in err:
                src_d, src_c = (s_d, s_c) if k == "agent_states" else (ts_d, ts_c)
                a, b = getattr(src_d, k).cpu(), getattr(src_c, k)
                if k != "reward":
                    a, b = a[~reset], b[~reset]
                if a.numel():
                    err[k] = max(err[k], (a - b).abs().max().item())
            if reset.any() and t < FORMATION_STEPS - 1:
                early_resets += int(reset.sum())
                s_d = to_dev(s_c)
        torch.cuda.synchronize()
        ok = (done_equal and counters_equal and max(err.values()) <= ENV_TOL and bool(reset.all())
              and (freezes == 0 if scen == "v4oct" else freezes > 0))
        return {"scenario": scen, "vehicle": veh, "formation": formation,
                "envs": ENV_CARD_ENVS, "steps": FORMATION_STEPS, "fixed_theta": FIXED_THETA,
                "placed_beside_goal": placed, "freezes": freezes,
                "early_reset_envs_resynced": early_resets, "max_abs_err": err,
                "done_equal": done_equal, "collision_counters_equal": counters_equal,
                "parity_reset_seconds": reset_s,
                "seconds_card_and_cpu": time.perf_counter() - t0, "ok": ok}

    t_phase = time.perf_counter()
    formation_rows = [formation_env_card_run(*c) for c in FORMATION_ENV_CARD]
    emit({"phase": "formations_env_card", "tol": ENV_TOL, "cases": formation_rows,
          "phase_seconds": time.perf_counter() - t_phase})
    if not all(r["ok"] for r in formation_rows):
        raise AssertionError(f"the card's formation episodes differ from the CPU's: "
                             f"{[r for r in formation_rows if not r['ok']]}")

    # ---------------------------------------------------------------- formations_train, _eval
    # july with circle at the flagship shape and v4oct with line and the
    # double integrator at v4oct_train's, each through train_and_eval
    # (no update profile): the float32 runs' launches, the restore, the
    # card-vs-CPU update, then the eval entry point
    flagship_n = ["--num_agents", str(ep.num_agents), "--n_rollout_threads", str(TRAIN_ENVS),
                  "--num_env_steps", str(WALLS_EPISODES * STEPS * TRAIN_ENVS)]
    circle_out, circle_ev = train_and_eval(
        "formations", common + flagship_n + ["--formation_type", "circle"], TRAIN_ENVS,
        FORMATION_CMP_ENVS, ["--num_agents", str(ep.num_agents)], False, case="july circle",
        profile=False)
    line_out, line_ev = train_and_eval(
        "formations", common + flagship_n + [
            "--formation_type", "line", "--scenario_name", V4OCT, "--dynamics_type",
            "double_integrator"], TRAIN_ENVS, FORMATION_CMP_ENVS,
        ["--scenario_name", V4OCT, "--num_agents", str(ep.num_agents)], False,
        case="v4oct line double_integrator", profile=False)

    # ---------------------------------------------------------------- bf16_train, bf16_eval
    # the JAX CLI's default command line (no --compute_dtype: bfloat16) at
    # the flagship shape: the float32 run's launches an episode, the
    # restore, an update profiled, one update's gradients card against CPU
    # at the bfloat16 bar; then the eval entry point (float32, as the JAX
    # package's)
    def bf16_update_vs_cpu(env_params, envs, cfg_kw=None, policy_kw=None, **runner_kw):
        """One update's first-epoch gradients in bfloat16 on the card and on
        the CPU and in float32 on the CPU, from one buffer and the same
        weights (the fields of ``cfg_kw`` and the policy arguments of
        ``policy_kw`` on every side): each leaf's and
        the loss's card distance from the CPU's float32 within BF16_RATIO x
        the CPU bfloat16 distance + the atols.  Returns the worst ratio to
        the bar, the largest card distance and both bfloat16 sides'
        losses."""
        cpu_ = torch.device("cpu")
        _, first, totals, _, _ = first_epoch_grads(env_params, envs, {
            "card": (dev, "bfloat16"), "cpu": (cpu_, "bfloat16"), "cpu_f32": (cpu_, "float32")},
            cfg_kw, policy_kw, **runner_kw)
        worst, card_err = 0.0, {}
        rows = [("loss", totals["card"], totals["cpu"], totals["cpu_f32"], BF16_ATOL)] + [
            (n, first["card"][n], first["cpu"][n], ref,
             BF16_GRAD_ATOL * ref.abs().max().item() + GRAD_ATOL)
            for n, ref in first["cpu_f32"].items()]
        for n, c, h, ref, atol in rows:
            d_card = torch.as_tensor(c - ref).abs().max().item()
            d_cpu = torch.as_tensor(h - ref).abs().max().item()
            bar = BF16_RATIO * d_cpu + atol
            worst, card_err[n] = max(worst, d_card / bar if bar else 0.0), d_card
            if d_card > bar:
                raise AssertionError(f"the card's bfloat16 {n} is {d_card} from the CPU's "
                                     f"float32, the CPU's bfloat16 {d_cpu}: bar {bar}")
        return worst, max(card_err.values()), {
            "card": {"loss": totals["card"]}, "cpu": {"loss": totals["cpu"],
                                                      "loss_float32": totals["cpu_f32"]}}

    bf16_argv = [a for a in common if a not in ("--compute_dtype", "float32")] + flagship_n
    if build_model_config(parse_all(bf16_argv)).compute_dtype != "bfloat16":
        raise AssertionError("the default command line does not compute in bfloat16")
    bf16_out, bf16_ev = train_and_eval(
        "bf16", bf16_argv, TRAIN_ENVS, BF16_CMP_ENVS, ["--num_agents", str(ep.num_agents)],
        False, case="july default dtype", compare=bf16_update_vs_cpu)

    # ---------------------------------------------------------------- safety_env_card
    # the filtered envs on the card against the CPU, env_card's protocol with
    # the filters' choices compared before every step (SAFETY_ENV_CARD)
    from contracts_marl_aam_corridors_tpu_torch.config.physics import RewardToggles
    from contracts_marl_aam_corridors_tpu_torch.envs import actions as action_mod
    from contracts_marl_aam_corridors_tpu_torch.safety import hj as hj_mod

    all_toggles = RewardToggles(safety_violation=True, hj_value=True, potential_conflict=True,
                                diff_from_filtered_action=True)

    def choices_differ(tr_c, tr_d, n_envs):
        """Per env, whether any choice of the two traces differs, and each
        differing choice's count and smallest and largest gap (the smaller
        of the two devices' gaps at each flip)."""
        differ = torch.zeros(n_envs, dtype=torch.bool)
        flips = {}
        for name, val in tr_c.items():
            if name == "applied":
                continue
            (ch_c, gap_c), (ch_d, gap_d) = val, tr_d[name]
            neq = ch_c != ch_d.cpu()
            if neq.any():
                gap = torch.minimum(gap_c, gap_d.cpu())[neq]
                flips[name] = {"count": int(neq.sum()), "min_gap": gap.min().item(),
                               "max_gap": gap.max().item()}
                differ |= neq.reshape(n_envs, -1).any(dim=1)
        return differ, flips

    def safety_env_card_run(label, veh, kw):
        """env_card_run on a filtered env: before each step both devices'
        filters are traced on their own states with the step's controls;
        an env where a choice differs is left out of that step's comparison
        and goes on from the CPU's state.  Requires some agent-steps
        filtered, and with HJ some on the evasive branch."""
        kw = dict(kw)
        if kw.pop("reward_toggles", None):
            kw["reward_toggles"] = all_toggles
        p_ = EnvParams(cfg=vehicle_config(veh), episode_length=ENV_CARD_STEPS, **kw)
        heading = p_.safety_filter_type != "rvo" and veh != "double_integrator"
        hj_c = hj_mod.make_synthetic_airtaxi_hj(p_.cfg) if heading else None
        hj_d = hj_c.to(dev, torch.float64) if heading else None
        table_c = torch.as_tensor(action_mod.action_table(p_.cfg, p_.total_actions),
                                  dtype=torch.float64)
        table_d = table_c.to(dev)
        g_c = torch.Generator().manual_seed(SEED + 14)
        g_d = torch.Generator(device=dev).manual_seed(SEED + 14)
        s_c, _ = env_mod.reset(p_, ENV_CARD_ENVS, g_c, cpu, torch.float64)
        s_d = to_dev(s_c)
        rng = np.random.RandomState(SEED + 14)
        n_, B_ = p_.num_agents, ENV_CARD_ENVS
        err = dict.fromkeys(("obs", "node_obs", "adj", "reward", "action_diff"), 0.0)
        done_equal = counters_equal = flags_equal = True
        early_resets = resynced = filtered_n = evasive_n = flipped_steps = 0
        flips, examples = {}, []
        draws = p_.cfg.dynamics != DynamicsType.DOUBLE_INTEGRATOR
        t0 = time.perf_counter()
        for t in range(ENV_CARD_STEPS):
            act = torch.as_tensor(rng.randint(0, p_.num_actions, (B_, n_)))
            tr_c, tr_d = {}, {}
            corridor_mod.safety_filter(p_, s_c.agent_states, table_c[act], hj_c, trace=tr_c)
            corridor_mod.safety_filter(p_, s_d.agent_states, table_d[act.to(dev)], hj_d,
                                       trace=tr_d)
            flipped, step_flips = choices_differ(tr_c, tr_d, B_)
            for name, f in step_flips.items():
                tot = flips.setdefault(name, {"count": 0, "min_gap": math.inf, "max_gap": 0.0})
                tot["count"] += f["count"]
                tot["min_gap"] = min(tot["min_gap"], f["min_gap"])
                tot["max_gap"] = max(tot["max_gap"], f["max_gap"])
                if len(examples) < 12:
                    examples.append({"step": t, "choice": name, **f})
            flipped_steps += int(flipped.sum())
            filtered_n += int(tr_c["filtered"][0].sum())
            if "evasive" in tr_c:
                evasive_n += int((tr_c["evasive"][0] & tr_c["applied"]).sum())
            before_c = s_c
            s_d, ts_d = env_mod.step(p_, s_d, act.to(dev), g_d, hj_d)
            s_c, ts_c = env_mod.step(p_, s_c, act, g_c, hj_c)
            reset = ts_c.done.all(dim=1)
            froze = ((s_c.status & ~before_c.status).any(dim=1) & ~reset if draws
                     else torch.zeros_like(reset))
            same = ~flipped
            done_equal &= torch.equal(ts_d.done.cpu()[same], ts_c.done[same])
            for k in ("Num_agent_collisions", "Num_obst_collisions"):
                counters_equal &= torch.equal(ts_d.info[k].cpu()[same], ts_c.info[k][same])
            went_on = ~(reset | froze | flipped)
            flags_equal &= torch.equal(s_d.safety_violations.cpu()[went_on],
                                       s_c.safety_violations[went_on])
            for k in err:
                src_d, src_c = (s_d, s_c) if k == "action_diff" else (ts_d, ts_c)
                a, b = getattr(src_d, k).cpu(), getattr(src_c, k)
                keep = same if k == "reward" else went_on
                a, b = a[keep], b[keep]
                if a.numel():
                    err[k] = max(err[k], (a - b).abs().max().item())
            early = bool(reset.any()) and t < ENV_CARD_STEPS - 1
            if froze.any() or flipped.any() or early:
                early_resets += int(early)
                resynced += int((froze | flipped).sum())
                s_d = to_dev(s_c)  # go on from the CPU's state
        torch.cuda.synchronize()
        fresh = bool(reset.all()) and bool((s_c.t == 0).all()) and bool((s_d.t == 0).all())
        agent_steps = ENV_CARD_STEPS * B_ * n_
        filtered_share = filtered_n / agent_steps
        evasive_share = evasive_n / agent_steps if heading else None
        gaps_ok = all(f["max_gap"] <= FLIP_GAP_BAR for f in flips.values())
        ok = (done_equal and counters_equal and flags_equal and max(err.values()) <= ENV_TOL
              and fresh and filtered_share > 0 and (not heading or evasive_share > 0)
              and gaps_ok)
        return {"case": label, "scenario": p_.scenario, "vehicle": veh,
                "filter": p_.safety_filter_type, "agents": n_, "walls": p_.num_walls,
                "entities": p_.num_entities, "envs": B_, "steps": ENV_CARD_STEPS,
                "reward_toggles": dataclasses.asdict(p_.reward_toggles),
                "filtered_share": filtered_share, "evasive_share": evasive_share,
                "flips": flips, "flip_examples": examples, "env_steps_with_a_flip": flipped_steps,
                "flip_gap_bar": FLIP_GAP_BAR, "max_abs_err": err, "done_equal": done_equal,
                "collision_counters_equal": counters_equal, "filtered_flags_equal": flags_equal,
                "early_resets": early_resets, "envs_resynced": resynced,
                "auto_reset_all": fresh, "seconds_card_and_cpu": time.perf_counter() - t0,
                "ok": ok}

    t_phase = time.perf_counter()
    safety_rows = [safety_env_card_run(*c) for c in SAFETY_ENV_CARD]
    emit({"phase": "safety_env_card", "tol": ENV_TOL, "cases": safety_rows,
          "phase_seconds": time.perf_counter() - t_phase})
    if not all(r["ok"] for r in safety_rows):
        raise AssertionError(f"the card's filtered envs differ from the CPU's: "
                             f"{[r for r in safety_rows if not r['ok']]}")

    # ---------------------------------------------------------------- safety_train, safety_eval
    # the train entry point with --use_safety_filter True: the flagship (the
    # air taxi's HJ filter on the synthetic table) and BASELINE config 4
    # (the double integrator's exponential CBF) at walls_train's 256 envs,
    # each through train_and_eval with its rollout step at N_ENVS envs
    # profiled; config 4's unfiltered step profiled beside it
    safety_flag = ["--use_safety_filter", "True"]
    hj_out, hj_ev = train_and_eval(
        "safety", common + flagship_n + safety_flag, TRAIN_ENVS, SAFETY_CMP_ENVS,
        ["--num_agents", str(ep.num_agents)], True, case="july air_taxi hj", profile=False)
    c4_argv = wall_argv + safety_flag
    c4_env = cli_train.build(parse_all(c4_argv))[0]
    if not (c4_env.use_safety_filter and c4_env.num_entities == 22):
        raise AssertionError(f"config 4's flags built {c4_env}")
    c4_out, c4_ev = train_and_eval(
        "safety", c4_argv, WALL_ENVS, WALL_CMP_ENVS,
        env_argv({k: v for k, v in WALL_ENV.items() if k in ("num_agents", "num_landmarks")}),
        True, case="config 4 exp_cbf", profile=False)
    _, _, w_trainer, w_runner = cli_train.build(parse_all(wall_argv))
    w_ts = w_trainer.init_state(SEED)
    w_roll = dataclasses.replace(w_runner, n_rollout_threads=N_ENVS)
    dataclasses.replace(w_roll, episode_length=2).collect(w_ts, w_roll.init_carry(SEED + 3))
    w_c0 = w_roll.init_carry(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w_roll.collect(w_ts, w_c0)
    torch.cuda.synchronize()
    w_collect_s = time.perf_counter() - t0
    emit({"phase": "safety_unfiltered_beside", "case": "config 4 without the filter",
          "envs": N_ENVS, "steps": STEPS, "wall_ms_per_step": w_collect_s * 1e3 / STEPS,
          "profile": collect_profile(w_roll, w_ts, SEED + 4, w_collect_s),
          "flagship_unfiltered_profile": profile})

    # ---------------------------------------------------------------- a12_train, a12_eval
    # the flagship with the curriculum and the critic on each agent's own
    # observation: two episodes, stages 1 and 5, each episode's rewards
    # recorded inside the CLI by wrapping Runner.train_episode
    stage_rews = []
    real_train_episode = Runner.train_episode

    def recording_train_episode(self, *a, **k):
        stage_rews.append({"collision_rew": self.env_params.collision_rew,
                           "formation_rew": self.env_params.formation_rew,
                           "use_centralized_v": self.use_centralized_v})
        return real_train_episode(self, *a, **k)

    a12_argv = common + flagship_n + ["--use_curriculum", "True", "--use_centralized_V"]
    base_c = parse_all(a12_argv)
    Runner.train_episode = recording_train_episode
    try:
        a12_out, a12_ev = train_and_eval(
            "a12", a12_argv, TRAIN_ENVS, SAFETY_CMP_ENVS, ["--num_agents", str(ep.num_agents)],
            False, case="july curriculum, centralized V off", profile=False,
            extra={"episode_rewards": stage_rews})
    finally:
        Runner.train_episode = real_train_episode
    want_rews = [{"collision_rew": base_c.collision_rew * st / 10,
                  "formation_rew": base_c.formation_rew * st / 10, "use_centralized_v": False}
                 for st in (1, 5)]
    if stage_rews != want_rews:
        raise AssertionError(f"the curriculum's episodes took {stage_rews}, expected {want_rews}")

    # ---------------------------------------------------------------- dense_card
    # the dense per-graph GNN (models/nets.py gnn_dense_nodes and
    # dense_aggregate) on the card at DENSE_CARD_SHAPES: averaged and
    # concatenated heads, relu and tanh, the node gather and the three
    # pools.  The card's float32 forward against the CPU's float64 forward
    # of the same module (first DENSE_CPU_GRAPHS graphs); at averaged heads
    # the dense route against the kernel trunk (rows 1 and 2) on the same
    # weights and graphs, all of them: forward at NET_TOL, and with tanh
    # the parameter gradients of all four aggregations' sum at the JAX bar,
    # or where the kernel's float32 gradient misses that bar against a
    # float64 evaluation, the dense one within twice the kernel's distance
    # from it (compare_leaves, the backward phase's criterion), or within
    # the bar of the float64 evaluation itself.
    import copy

    t_phase = time.perf_counter()
    dense_rows, dense_kernel_launches = [], [0, 0]
    for E_, F_, B_, with_grads in DENSE_CARD_SHAPES:
        g_ = torch.Generator(device=dev).manual_seed(SEED + 20 + E_)
        d_node, d_adj = random_graphs(B_, E_, cfg.max_edge_dist, g_, F=F_)
        d_aid = torch.randint(0, 3, (B_, 1), generator=g_, device=dev)
        n_cpu = min(B_, DENSE_CPU_GRAPHS)
        cpu_in = (d_node[:n_cpu].cpu(), d_adj[:n_cpu].cpu(), d_aid[:n_cpu].cpu())
        for concat in (False, True):
            for relu in (True, False):
                c_ = ModelConfig(max_edge_dist=cfg.max_edge_dist, gnn_concat_heads=concat,
                                 gnn_impl="dense", use_relu=relu, embed_use_relu=relu,
                                 gnn_use_relu=relu)
                d_gnn = nets.GNNBase(c_, F_, "node")
                d_gnn.init_(torch.Generator().manual_seed(SEED + 11))
                cpu_gnn = copy.deepcopy(d_gnn)
                d_gnn = d_gnn.to(dev)
                row = {"E": E_, "node_feat_dim": F_, "graphs": B_, "cpu_graphs": n_cpu,
                       "heads": "concat" if concat else "averaged",
                       "act": "relu" if relu else "tanh"}
                with torch.no_grad():
                    card_nodes = nets.gnn_dense_nodes(c_, d_gnn, d_node, d_adj)
                    torch.cuda.synchronize()
                    finite = bool(torch.isfinite(card_nodes).all())
                    cpu32 = nets.gnn_dense_nodes(c_, cpu_gnn, *cpu_in[:2])
                    cpu64 = nets.gnn_dense_nodes(c_, cpu_gnn.double(), cpu_in[0].double(),
                                                 cpu_in[1].double())
                    ok, f64 = finite, {}
                    for aggr in DENSE_AGGRS:
                        agg = lambda x: nets.dense_aggregate(x, aggr, cpu_in[2].to(x.device))
                        x64 = agg(cpu64)
                        e_card = (agg(card_nodes[:n_cpu]).cpu().double() - x64).abs().max().item()
                        e_cpu = (agg(cpu32).double() - x64).abs().max().item()
                        f64[aggr] = {"card_vs_f64": e_card, "cpu_f32_vs_f64": e_cpu}
                        ok &= e_card <= DENSE_F64_RATIO * e_cpu + DENSE_F64_ATOL
                    row["card_vs_cpu_f64"] = f64
                    row["dense_forward_ms"] = time_ms(
                        torch, lambda: nets.gnn_dense_nodes(c_, d_gnn, d_node, d_adj), reps=5,
                        warmup=1)
                if not concat:
                    # the kernel trunk on the same weights and graphs
                    ck = dataclasses.replace(c_, gnn_impl="transposed")
                    launches0 = (gnn_trunk.gnn_trunk_forward.launches,
                                 gnn_trunk.gnn_trunk_backward.launches)
                    vs_kernel = {}
                    with torch.no_grad():
                        for aggr in DENSE_AGGRS:
                            dk = nets.dense_aggregate(card_nodes, aggr, d_aid)
                            kk = nets.gnn_transposed_apply(ck, d_gnn, d_node, d_adj, d_aid, aggr)
                            vs_kernel[aggr] = (dk - kk).abs().max().item()
                            ok &= torch.allclose(dk, kk, **NET_TOL)
                        row["kernel_forward_ms"] = time_ms(
                            torch, lambda: nets.gnn_transposed_apply(ck, d_gnn, d_node, d_adj,
                                                                     d_aid, "node"),
                            reps=5, warmup=1)
                    row["dense_vs_kernel_forward_max_abs_err"] = vs_kernel
                    if with_grads and not relu:
                        params_ = list(d_gnn.parameters())
                        cots = torch.randn((len(DENSE_AGGRS), B_, c_.gnn_out_dim),
                                           generator=g_, device=dev)

                        def loss_of(apply):
                            return sum((apply(a) * cots[i]).sum()
                                       for i, a in enumerate(DENSE_AGGRS))

                        nodes_g = nets.gnn_dense_nodes(c_, d_gnn, d_node, d_adj)
                        gd = torch.autograd.grad(loss_of(
                            lambda a: nets.dense_aggregate(nodes_g, a, d_aid)), params_)
                        del nodes_g
                        gk = torch.autograd.grad(loss_of(
                            lambda a: nets.gnn_transposed_apply(ck, d_gnn, d_node, d_adj, d_aid,
                                                                a)), params_)
                        # the float64 evaluation, for leaves whose float32
                        # kernel gradient misses the bar against it (a key
                        # bias's gradient is zero but for rounding: the
                        # softmax over the sources takes its shift away)
                        g64 = copy.deepcopy(d_gnn).double()
                        nodes64 = nets.gnn_dense_nodes(c_, g64, d_node.double(), d_adj.double())
                        cots = cots.double()
                        gx = torch.autograd.grad(loss_of(
                            lambda a: nets.dense_aggregate(nodes64, a, d_aid)),
                            list(g64.parameters()))
                        del nodes64, g64
                        # the kernels' plain version (float32 torch on the
                        # card), the same trunk output aggregated four ways
                        src_p = nets._gnn_src_T(d_gnn, d_node)
                        out_p = gnn_trunk.gnn_trunk_forward_plain(
                            *nets._trunk_dims(c_, E_, src_p.shape[0] // E_),
                            nets._flatten_gnn_params(d_gnn, c_.embed_layer_n, c_.gnn_layer_n),
                            src_p, nets._adj_T(d_adj))
                        gp = torch.autograd.grad(loss_of(lambda a: nets._gnn_aggregate(
                            out_p, a, d_aid, E_, c_.gnn_hidden_size).double()), params_)
                        del src_p, out_p
                        leaves = compare_leaves(gd, gk, gx)
                        names_ = [n for n, _ in d_gnn.named_parameters()]
                        row["dense_vs_kernel_grad_worst_ratio_to_bar"] = max(
                            r["max_abs_err"] / r["bar"] for r in leaves)
                        row["grad_leaves_past_the_bar"] = {
                            n: {"max_abs_err": r["max_abs_err"], "bar": r["bar"],
                                "dense_vs_f64": r["kernel_vs_f64"],
                                "kernel_vs_f64": r["plain_vs_f64"],
                                "plain_vs_f64": (p_.double() - x_).abs().max().item()}
                            for n, r, p_, x_ in zip(names_, leaves, gp, gx)
                            if r["max_abs_err"] > r["bar"]}
                        # a key bias's gradient is rounding around zero:
                        # where the two float32 routes differ past the bar
                        # with the kernel inside it, the dense one must lie
                        # within the bar of the float64 evaluation too
                        ok &= all(r["ok"] or r["kernel_vs_f64"] <= r["bar"] for r in leaves)
                    launched = (gnn_trunk.gnn_trunk_forward.launches - launches0[0],
                                gnn_trunk.gnn_trunk_backward.launches - launches0[1])
                    row["kernel_launches"] = {"forward": launched[0], "backward": launched[1]}
                    dense_kernel_launches[0] += launched[0]
                    dense_kernel_launches[1] += launched[1]
                    if launched[0] < len(DENSE_AGGRS):
                        raise AssertionError(f"dense_card: the kernel side launched row 1 "
                                             f"{launched[0]} times")
                row["ok"] = bool(ok)
                dense_rows.append(row)
                del card_nodes, cpu32, cpu64
        del d_node, d_adj, d_aid
        torch.cuda.empty_cache()
    emit({"phase": "dense_card", "rows": dense_rows,
          "f64_bar": f"card <= {DENSE_F64_RATIO} x cpu_f32 + {DENSE_F64_ATOL}",
          "phase_seconds": time.perf_counter() - t_phase})
    if not all(r["ok"] for r in dense_rows):
        raise AssertionError(f"dense_card: {[(r['E'], r['heads'], r['act']) for r in dense_rows if not r['ok']]}")

    # ---------------------------------------------------------------- dense_train, dense_eval
    # the flagship with --gnn_impl dense in float32: two episodes, no trunk
    # kernel launched; on one buffer the first-epoch gradients of the dense
    # route against the kernel route from the same weights, on the card
    dense_specs = {"dense": (dev, "float32", {"gnn_impl": "dense"}),
                   "kernel": (dev, "float32", {"gnn_impl": "transposed"})}
    dense_out, dense_ev = train_and_eval(
        "dense", common + flagship_n + ["--gnn_impl", "dense"], TRAIN_ENVS, DENSE_CMP_ENVS,
        ["--num_agents", str(ep.num_agents)], False, case="flagship --gnn_impl dense",
        kernel_route=False, compare_key="dense_vs_kernel",
        compare=lambda env_, envs_, **kw: update_card_vs_cpu(env_, envs_, specs=dense_specs,
                                                             **kw))

    # ---------------------------------------------------------------- concat_train, concat_eval
    # the flagship with --gnn_concat_heads at the CLI's default bfloat16: two
    # episodes through the dense GNN; one update's gradients card against
    # CPU at the bfloat16 bar
    concat_argv = [a for a in common if a not in ("--compute_dtype", "float32")] + flagship_n + [
        "--gnn_concat_heads"]
    if build_model_config(parse_all(concat_argv)).compute_dtype != "bfloat16":
        raise AssertionError("the concat-heads command line does not compute in bfloat16")
    concat_out, concat_ev = train_and_eval(
        "concat", concat_argv, TRAIN_ENVS, BF16_CMP_ENVS, ["--num_agents", str(ep.num_agents)],
        False, case="flagship --gnn_concat_heads, bfloat16", kernel_route=False,
        compare=lambda env_, envs_, **kw: bf16_update_vs_cpu(
            env_, envs_, cfg_kw={"gnn_concat_heads": True}, **kw))

    # ---------------------------------------------------------------- aggr_train, aggr_eval
    # BASELINE config 2 (E = 13) with the actor's global max pool, float32:
    # one episode; one update card against CPU, both on the dense GNN
    aggr_kw = {"actor_graph_aggr": "global", "global_aggr_type": "max"}
    aggr_argv = common + env_argv(OBST_ENV) + env_argv(aggr_kw) + [
        "--dynamics_type", "air_taxi", "--n_rollout_threads", str(TRAIN_ENVS),
        "--num_env_steps", str(STEPS * TRAIN_ENVS)]
    aggr_out, aggr_ev = train_and_eval(
        "aggr", aggr_argv, TRAIN_ENVS, DENSE_CMP_ENVS,
        env_argv({k: v for k, v in OBST_ENV.items() if k != "world_size"}), False,
        case="config 2 --actor_graph_aggr global --global_aggr_type max", episodes=1,
        kernel_route=False,
        compare=lambda env_, envs_, **kw: update_card_vs_cpu(env_, envs_, cfg_kw=aggr_kw, **kw))

    # ---------------------------------------------------------------- packed_card
    # the packed edge layout (models/nets.py embed_conv_packed) on the card at
    # PACKED_CARD_SHAPES, tanh: the packed EmbedConv alone and the whole dense
    # GNN in that layout, forward and the parameter gradients of
    # sum(out * cotangent).  Float32, on all the graphs: the forward against
    # the dense layout at PACKED_FWD_TOL, and on the first PACKED_CPU_GRAPHS
    # against the CPU's float64 at dense_card's bar; the gradients at
    # dense_card's bar (compare_leaves: packed against dense at the JAX bar,
    # or within twice the dense layout's distance from a float64 evaluation
    # on the card, or within the JAX bar of it).  Bfloat16 on the first
    # PACKED_CPU_GRAPHS graphs: the card's forward and gradients within the
    # bfloat16 bar (BF16_RATIO ...) of the CPU's float32 (the CPU's bfloat16
    # in the JAX package's place).  The packed forward's ms beside the dense layout's, float32 and
    # bfloat16, on all the graphs.
    def packed_part(part, c_, gnn, node, adj):
        """The packed or dense EmbedConv alone (``part`` 'embed_conv'), or
        the dense GNN's per-node output ('gnn'), as gnn_dense_nodes casts."""
        if part == "gnn":
            return nets.gnn_dense_nodes(c_, gnn, node, adj)
        cdt = torch.bfloat16 if c_.bf16 else gnn.embed_layer.lin1.weight.dtype
        mask, attr = nets.adjacency_mask(adj, c_.max_edge_dist)
        embed = nets.embed_conv_packed if c_.gnn_edge_packed else nets.embed_conv_dense
        return embed(c_, gnn.embed_layer, node.to(cdt), mask, attr.to(cdt))

    def part_grads(part, c_, gnn, node, adj, cot):
        params_ = [p for n, p in gnn.named_parameters()
                   if part == "gnn" or n.startswith("embed_layer.")]
        out = packed_part(part, c_, gnn, node, adj)
        return torch.autograd.grad((out.to(cot.dtype) * cot).sum(), params_)

    t_phase = time.perf_counter()
    packed_rows = []
    for E_, F_, B_ in PACKED_CARD_SHAPES:
        g_ = torch.Generator(device=dev).manual_seed(SEED + 40 + E_)
        p_node, p_adj = random_graphs(B_, E_, cfg.max_edge_dist, g_, F=F_)
        n_cpu = min(B_, PACKED_CPU_GRAPHS)
        cpu_node, cpu_adj = p_node[:n_cpu].cpu(), p_adj[:n_cpu].cpu()
        kw_ = dict(max_edge_dist=cfg.max_edge_dist, gnn_impl="dense", use_relu=False,
                   embed_use_relu=False, gnn_use_relu=False)
        cfgs = {(packed, dt): ModelConfig(**kw_, gnn_edge_packed=packed, compute_dtype=dt)
                for packed in (True, False) for dt in ("float32", "bfloat16")}
        cpu_gnn = nets.GNNBase(cfgs[(True, "float32")], F_, "node")
        init_gen = torch.Generator().manual_seed(SEED + 12)
        cpu_gnn.init_(init_gen)
        with torch.no_grad():
            for p_ in cpu_gnn.parameters():
                p_.add_(0.1 * torch.randn(p_.shape, generator=init_gen))
        d_gnn = copy.deepcopy(cpu_gnn).to(dev)
        for part in ("embed_conv", "gnn"):
            cot = torch.randn((B_, E_, 16), generator=g_, device=dev)
            row = {"part": part, "E": E_, "node_feat_dim": F_, "graphs": B_,
                   "cpu_graphs": n_cpu}
            ok = True
            with torch.no_grad():
                # float32: packed against dense on the card, against float64
                pk = packed_part(part, cfgs[(True, "float32")], d_gnn, p_node, p_adj)
                dn = packed_part(part, cfgs[(False, "float32")], d_gnn, p_node, p_adj)
                ok &= bool(torch.isfinite(pk).all())
                row["packed_vs_dense_max_abs_err"] = (pk - dn).abs().max().item()
                row["packed_vs_dense_worst_ratio_to_bar"] = ((pk - dn).abs() / (
                    PACKED_FWD_TOL["atol"] + PACKED_FWD_TOL["rtol"] * dn.abs())).max().item()
                ok &= row["packed_vs_dense_worst_ratio_to_bar"] <= 1.0
                c32 = packed_part(part, cfgs[(True, "float32")], cpu_gnn, cpu_node, cpu_adj)
                c64 = packed_part(part, cfgs[(True, "float32")], copy.deepcopy(cpu_gnn).double(),
                                  cpu_node.double(), cpu_adj.double())
                e_card = (pk[:n_cpu].cpu().double() - c64).abs().max().item()
                e_cpu = (c32.double() - c64).abs().max().item()
                row["card_vs_cpu_f64"] = {"card_vs_f64": e_card, "cpu_f32_vs_f64": e_cpu}
                ok &= e_card <= DENSE_F64_RATIO * e_cpu + DENSE_F64_ATOL
                # bfloat16 forward: the card and the CPU against the CPU's float32
                k16 = packed_part(part, cfgs[(True, "bfloat16")], d_gnn, p_node, p_adj)
                h16 = packed_part(part, cfgs[(True, "bfloat16")], cpu_gnn, cpu_node, cpu_adj)
                d16_card = (k16[:n_cpu].cpu().float() - c32).abs().max().item()
                d16_cpu = (h16.float() - c32).abs().max().item()
                row["bf16_forward"] = {"card_vs_cpu_f32": d16_card, "cpu_bf16_vs_cpu_f32": d16_cpu,
                                       "card_vs_cpu_bf16": (k16[:n_cpu].cpu().float()
                                                            - h16.float()).abs().max().item()}
                ok &= d16_card <= BF16_RATIO * d16_cpu + BF16_ATOL
                ms = {}
                for (packed, dt), c_ in cfgs.items():
                    ms[f"{'packed' if packed else 'dense'}_{dt}"] = time_ms(
                        torch, lambda c_=c_: packed_part(part, c_, d_gnn, p_node, p_adj),
                        reps=5, warmup=1)
                row["forward_ms"] = ms
                del pk, dn, k16
            # float32 gradients on all the graphs: packed, dense, float64
            gp = part_grads(part, cfgs[(True, "float32")], d_gnn, p_node, p_adj, cot)
            gd = part_grads(part, cfgs[(False, "float32")], d_gnn, p_node, p_adj, cot)
            g64 = copy.deepcopy(d_gnn).double()
            gx = part_grads(part, cfgs[(True, "float32")], g64, p_node.double(),
                            p_adj.double(), cot.double())
            del g64
            leaves = compare_leaves(gp, gd, gx)
            row["grad_packed_vs_dense_worst_ratio_to_bar"] = max(
                r["max_abs_err"] / r["bar"] for r in leaves)
            row["grad_packed_vs_f64_worst"] = max(r["kernel_vs_f64"] for r in leaves)
            names_ = [n for n, _ in d_gnn.named_parameters()
                      if part == "gnn" or n.startswith("embed_layer.")]
            row["grad_leaves_past_the_bar"] = {
                n: {"max_abs_err": r["max_abs_err"], "bar": r["bar"],
                    "packed_vs_f64": r["kernel_vs_f64"], "dense_vs_f64": r["plain_vs_f64"]}
                for n, r in zip(names_, leaves) if r["max_abs_err"] > r["bar"]}
            ok &= all(r["ok"] or r["kernel_vs_f64"] <= r["bar"] for r in leaves)
            # bfloat16 gradients on the first PACKED_CPU_GRAPHS graphs
            sub = (p_node[:n_cpu], p_adj[:n_cpu], cot[:n_cpu])
            cpu_sub = tuple(t.cpu() for t in sub)
            gk16 = part_grads(part, cfgs[(True, "bfloat16")], d_gnn, *sub)
            gh16 = part_grads(part, cfgs[(True, "bfloat16")], cpu_gnn, *cpu_sub)
            gh32 = part_grads(part, cfgs[(True, "float32")], cpu_gnn, *cpu_sub)
            worst16 = 0.0
            for k_, h_, ref in zip(gk16, gh16, gh32):
                d_card = (k_.cpu().float() - ref).abs().max().item()
                d_cpu = (h_.float() - ref).abs().max().item()
                bar = BF16_RATIO * d_cpu + BF16_GRAD_ATOL * ref.abs().max().item() + GRAD_ATOL
                worst16 = max(worst16, d_card / bar)
            row["bf16_grad_worst_ratio_to_bar"] = worst16
            ok &= worst16 <= 1.0
            row["ok"] = bool(ok)
            packed_rows.append(row)
            del gp, gd, gx, gk16
        del p_node, p_adj, d_gnn
        torch.cuda.empty_cache()
    emit({"phase": "packed_card", "rows": packed_rows,
          "bars": {"packed_vs_dense": PACKED_FWD_TOL,
                   "f64": f"card <= {DENSE_F64_RATIO} x cpu_f32 + {DENSE_F64_ATOL}",
                   "bf16": f"card <= {BF16_RATIO} x cpu_bf16 + {BF16_ATOL} (gradients: + "
                           f"{BF16_GRAD_ATOL} x max + {GRAD_ATOL})"},
          "phase_seconds": time.perf_counter() - t_phase})
    if not all(r["ok"] for r in packed_rows):
        raise AssertionError(f"packed_card: {[(r['part'], r['E']) for r in packed_rows if not r['ok']]}")

    # ---------------------------------------------------------------- fused_card
    # Run 1: the dense route's first-epoch update fused (--fuse_gnn_trunks)
    # and unfused on the card, from the same weights and one buffer of
    # DENSE_CMP_ENVS envs: values, log-probs and entropy at FUSED_TOL, every
    # leaf's gradient at FUSED_GRAD_TOL; then both 2-epoch updates profiled
    # on one flagship buffer (TRAIN_ENVS envs), side by side.  Run 2: the
    # kernel route with both flags through the CLIs, which must launch rows
    # 1 and 2 as without them and rows 3 and 4 never (train_and_eval's
    # launch check).
    t_phase = time.perf_counter()
    fused_specs = {"fused": (dev, "float32", {}, {"fuse_gnn_trunks": True}),
                   "unfused": (dev, "float32")}
    f_sides, f_first, _, f_buf, _ = first_epoch_grads(ep, DENSE_CMP_ENVS, fused_specs,
                                                      {"gnn_impl": "dense"})
    f_outs = {}
    for side, (tr, st) in f_sides.items():
        batch = tr._time_major(tr.chunks(st, f_buf))
        with torch.no_grad():
            f_outs[side] = tr.policy.evaluate_actions(
                st.params, batch["share_obs"], batch["obs"], batch["node_obs"], batch["adj"],
                batch["agent_id"], batch["h_actor"], batch["h_critic"], batch["actions"],
                batch["masks"], batch["avail"], batch["active_masks"])
    if not (f_sides["fused"][0].policy._fused_routable()
            and not f_sides["unfused"][0].policy._fused_routable()):
        raise AssertionError("fused_card: the fused side does not route to the fused trunks")
    fused_run = {"envs": DENSE_CMP_ENVS, "outputs_max_abs_err": {}, "grad_worst_ratio_to_bar": 0.0}
    for name, a_, b_ in zip(("values", "log_probs", "entropy"), f_outs["fused"],
                            f_outs["unfused"]):
        fused_run["outputs_max_abs_err"][name] = (a_ - b_).abs().max().item()
        if not torch.allclose(a_, b_, **FUSED_TOL):
            raise AssertionError(f"fused_card: fused and unfused {name} disagree")
    for n, want in f_first["unfused"].items():
        got = f_first["fused"][n]
        ratio = ((got - want).abs() / (FUSED_GRAD_TOL["atol"]
                                       + FUSED_GRAD_TOL["rtol"] * want.abs())).max().item()
        fused_run["grad_worst_ratio_to_bar"] = max(fused_run["grad_worst_ratio_to_bar"], ratio)
        if ratio > 1.0 or (n.startswith(("actor.gnn_base", "critic.gnn_base"))
                           and "lin_key.bias" not in n and not got.abs().max() > 0):
            raise AssertionError(f"fused_card: fused gradient of {n} at {ratio} of the bar")
    # the two updates profiled on one flagship buffer
    prof_base = Runner(env_params=ep, policy=f_sides["unfused"][0].policy,
                       trainer=f_sides["unfused"][0], n_rollout_threads=TRAIN_ENVS,
                       episode_length=STEPS)
    _, prof_buf, _ = prof_base.collect(f_sides["unfused"][1], prof_base.init_carry(SEED + 8))
    fused_profiles = {}
    for side, (tr, st) in f_sides.items():
        fused_profiles[side], _ = update_profile_of(
            dataclasses.replace(prof_base, policy=tr.policy, trainer=tr), st, None, prof_buf)
        if fused_profiles[side]["trunk_kernel_launches"]:
            raise AssertionError(f"fused_card: the {side} update ran trunk kernels")
    del prof_buf
    # one attention softmax a conv layer for both networks, against one a
    # conv layer and network
    sm_f = fused_profiles["fused"]["softmax_ops_per_epoch"]
    sm_u = fused_profiles["unfused"]["softmax_ops_per_epoch"]
    if not (sm_f == 1 + cfg.gnn_layer_n and sm_u == 2 * sm_f):
        raise AssertionError(f"fused_card: softmax ops an epoch fused {sm_f}, unfused {sm_u}")
    fk_argv = common + flagship_n + ["--fuse_gnn_trunks", "True", "--gnn_edge_packed", "True"]
    fk_out, fk_ev = train_and_eval(
        "fused_kernel_route", fk_argv, TRAIN_ENVS, SAFETY_CMP_ENVS,
        ["--num_agents", str(ep.num_agents)], False,
        case="flagship kernel route --fuse_gnn_trunks True --gnn_edge_packed True", profile=False,
        compare=lambda env_, envs_, **kw: update_card_vs_cpu(
            env_, envs_, cfg_kw={"gnn_edge_packed": True}, policy_kw={"fuse_gnn_trunks": True},
            **kw))
    emit({"phase": "fused_card", "run1_dense_update": fused_run,
          "run1_update_profiles": {side: {k: v for k, v in prof.items()
                                          if k != "top_device_ms_per_epoch"}
                                   for side, prof in fused_profiles.items()},
          "run1_top_device_ms_per_epoch": {side: prof["top_device_ms_per_epoch"]
                                           for side, prof in fused_profiles.items()},
          "run2_kernel_route": {"argv": fk_argv, "trunk_launches": fk_out["trunk_launches"],
                                "eval_launches": fk_ev},
          "bars": {"outputs": FUSED_TOL, "grads": FUSED_GRAD_TOL},
          "phase_seconds": time.perf_counter() - t_phase})

    # ---------------------------------------------------------------- packed_train, packed_eval
    # the flagship at the CLI's default bfloat16 with --gnn_impl dense
    # --gnn_edge_packed True --fuse_gnn_trunks True: two episodes, no trunk
    # kernel; one update's gradients card against CPU at the bfloat16 bar
    packed_argv = [a for a in common if a not in ("--compute_dtype", "float32")] + flagship_n + [
        "--gnn_impl", "dense", "--gnn_edge_packed", "True", "--fuse_gnn_trunks", "True"]
    packed_policy = cli_train.build(parse_all(packed_argv))[1]
    if not (packed_policy.cfg.bf16 and packed_policy.cfg.gnn_edge_packed
            and packed_policy._fused_routable()):
        raise AssertionError("the packed command line does not train packed and fused in "
                             "bfloat16")
    del packed_policy
    packed_out, packed_ev = train_and_eval(
        "packed", packed_argv, TRAIN_ENVS, BF16_CMP_ENVS, ["--num_agents", str(ep.num_agents)],
        False, case="flagship --gnn_impl dense --gnn_edge_packed --fuse_gnn_trunks, bfloat16",
        kernel_route=False,
        compare=lambda env_, envs_, **kw: bf16_update_vs_cpu(
            env_, envs_, cfg_kw={"gnn_impl": "dense", "gnn_edge_packed": True},
            policy_kw={"fuse_gnn_trunks": True}, **kw))

    # ---------------------------------------------------------------- summary
    emit({"kernels": [{
        "name": "gnn_trunk_fwd", "route": "cuda",
        "source": f"{PACKAGE}/csrc/gnn_trunk_fwd.cu",
        "replaces": "contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:299",
        "launches": episodes[-1]["forward_launches"], "rollout_launches": launches,
        "eval_launches": eval_launches, "checkpoint_eval_launches": ck_launches[0],
        "gated_checkpoint_eval_launches": {k: v["launches"] for k, v in gated_ck.items()},
        "gated_train_launches": gt_fl, "v4oct_train_launches": v4_launches[0],
        "v4oct_eval_launches": v4_ev_launches[0],
        "obstacles_train_launches": obst_out["trunk_launches"]["forward"],
        "walls_train_launches": wall_out["trunk_launches"]["forward"],
        "obstacles_eval_launches": obst_ev[0], "walls_eval_launches": wall_ev[0],
        "formations_train_launches": {
            "july circle": circle_out["trunk_launches"]["forward"],
            "v4oct line": line_out["trunk_launches"]["forward"]},
        "formations_eval_launches": {"july circle": circle_ev[0], "v4oct line": line_ev[0]},
        "bf16_train_launches": bf16_out["trunk_launches"]["forward"],
        "bf16_eval_launches": bf16_ev[0],
        "safety_train_launches": {"july hj": hj_out["trunk_launches"]["forward"],
                                  "config 4 exp_cbf": c4_out["trunk_launches"]["forward"]},
        "safety_eval_launches": {"july hj": hj_ev[0], "config 4 exp_cbf": c4_ev[0]},
        "a12_train_launches": a12_out["trunk_launches"]["forward"],
        "a12_eval_launches": a12_ev[0],
        # the dense GNN's runs launch no trunk kernel (dense_card's launches
        # are the comparison's, on no path)
        "dense_route_train_launches": {
            "dense": dense_out["trunk_launches"]["forward"],
            "concat": concat_out["trunk_launches"]["forward"],
            "aggr": aggr_out["trunk_launches"]["forward"]},
        "dense_route_eval_launches": {"dense": dense_ev[0], "concat": concat_ev[0],
                                      "aggr": aggr_ev[0]},
        "dense_card_comparison_launches": dense_kernel_launches[0],
        # both layout flags on the kernel route (as without them), and the
        # packed, fused dense route (none)
        "fused_kernel_route_train_launches": fk_out["trunk_launches"]["forward"],
        "fused_kernel_route_eval_launches": fk_ev[0],
        "packed_train_launches": packed_out["trunk_launches"]["forward"],
        "packed_eval_launches": packed_ev[0],
        "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "ms_by_graphs": {r["B"]: r["ms"] for r in sizes},
        "ms_by_shape": {f"E{r['E']}_Ds{r['Ds']}_B{r['B']}": r["ms"]
                        for r in walls_trunk if r["row"] == 1},
        "bound_ms_by_graphs": {r["B"]: r["bound_ms"] for r in sizes},
        "library_ms": None,
    }, {
        "name": "gnn_trunk_bwd", "route": "cuda",
        "source": f"{PACKAGE}/csrc/gnn_trunk_bwd.cu",
        "replaces": "contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:594",
        "launches": episodes[-1]["backward_launches"], "gated_train_launches": gt_bl,
        "v4oct_train_launches": v4_launches[1],
        "obstacles_train_launches": obst_out["trunk_launches"]["backward"],
        "walls_train_launches": wall_out["trunk_launches"]["backward"],
        "formations_train_launches": {
            "july circle": circle_out["trunk_launches"]["backward"],
            "v4oct line": line_out["trunk_launches"]["backward"]},
        "bf16_train_launches": bf16_out["trunk_launches"]["backward"],
        "safety_train_launches": {"july hj": hj_out["trunk_launches"]["backward"],
                                  "config 4 exp_cbf": c4_out["trunk_launches"]["backward"]},
        "a12_train_launches": a12_out["trunk_launches"]["backward"],
        "dense_route_train_launches": {
            "dense": dense_out["trunk_launches"]["backward"],
            "concat": concat_out["trunk_launches"]["backward"],
            "aggr": aggr_out["trunk_launches"]["backward"]},
        "dense_card_comparison_launches": dense_kernel_launches[1],
        "fused_kernel_route_train_launches": fk_out["trunk_launches"]["backward"],
        "packed_train_launches": packed_out["trunk_launches"]["backward"],
        "max_abs_err": bwd_max_err,
        "ms_by_shape": {f"E{r['E']}_Ds{r['Ds']}_B{r['B']}_{'relu' if r['acts'][1] else 'tanh'}":
                        r["ms"] for r in walls_trunk if r["row"] == 2},
        "ms": bwd_ms, "plain_ms": plain_bwd_ms, "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by, "library_ms": None,
    }, {
        "name": "gnn_trunk_dual_fwd", "route": "cuda",
        "source": f"{PACKAGE}/csrc/gnn_trunk_dual_fwd.cu",
        "replaces": "contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:703",
        "launches": path_launches[2], "max_abs_err": dual_fwd_err,
        "ms": dual_fwd_ms, "two_single_ms": two_fwd_ms, "plain_ms": plain_dual_fwd_ms,
        "bound_ms": dual_fwd_bound, "bound_by": dual_fwd_by,
        "ms_by_graphs": {r["B"]: r["ms"] for r in dual_sizes},
        "two_single_ms_by_graphs": {r["B"]: r["two_single_ms"] for r in dual_sizes},
        "bound_ms_by_graphs": {r["B"]: r["bound_ms"] for r in dual_sizes},
        "library_ms": None,
    }, {
        "name": "gnn_trunk_dual_bwd", "route": "cuda",
        "source": f"{PACKAGE}/csrc/gnn_trunk_dual_bwd.cu",
        "replaces": "contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:712",
        "launches": path_launches[3], "max_abs_err": dual_bwd_err,
        "ms": dual_bwd_ms, "two_single_ms": two_bwd_ms, "plain_ms": plain_dual_bwd_ms,
        "bound_ms": dual_bwd_bound, "bound_by": dual_bwd_by, "library_ms": None,
    }, {
        "name": "gnn_forward_v2", "route": "cuda",
        "source": f"{PACKAGE}/csrc/gnn_forward_v2.cu",
        "replaces": "contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:72",
        "launches": v2_path_launches[-1], "checkpoint_eval_launches": ck_launches[-1],
        "max_abs_err": v2_max_err, "ms": v2_ms["ms"], "row1_ms": v2_ms["row1_ms"],
        "ms_76800": v2_timing[B_UPD]["ms"], "plain_ms": v2_ms["plain_ms"],
        "bound_ms": v2_ms["bound_ms"], "bound_by": v2_ms["bound_by"],
        "dense_bound_ms": v2_ms["dense_bound_ms"],
        "ms_by_graphs": {r["B"]: r["ms"] for r in v2_timing.values()},
        "row1_ms_by_graphs": {r["B"]: r["row1_ms"] for r in v2_timing.values()},
        "bound_ms_by_graphs": {r["B"]: r["bound_ms"] for r in v2_timing.values()},
        "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
