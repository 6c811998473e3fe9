#!/usr/bin/env python3
"""Drive the torch port's july rollout, evaluation, PPO training, train
CLI and eval CLI on one CUDA card.

    python3 chip_smoke.py

Builds the port's kernels (``csrc/gnn_trunk_fwd.cu``, ``gnn_trunk_bwd.cu``,
``gnn_trunk_dual_fwd.cu``, ``gnn_trunk_dual_bwd.cu`` and
``gnn_forward_v2.cu``, one ``nvcc`` each for sm_90a, in parallel), holds
each against its plain torch version on the card (and the v2 forward also
against the trunk forward kernel), runs ``Runner.collect`` at 4096 envs x
25 steps, ``Runner.eval_episode`` at 1024 envs, ``Runner.train_episode`` at
1024 envs x 25 steps with 15 PPO epochs, both trunks through
``nets.gnn_transposed_apply_dual`` at the update's shape, ``make_gnn_forward_v2``,
the train CLI (``cli.train.main``, three flagship episodes, a checkpoint
restore and a resume), the shipped july checkpoint
(``model_weights_torch/july/unicycle``) under the JAX package's batched
evaluation, held to its JAX numbers (``jax_eval.json``), and the eval CLI
(``cli.eval.main``) on it, all at the default model's full width, and
checks that every GNN trunk forward and backward of those paths went
through the kernels.  Prints one JSON line per phase (device, build,
kernel, backward, dual, v2, rollout, eval, train, cli, checkpoint,
eval_cli, kernels), then the card's name and power limit as
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
# deviations of the difference.  Collisions are printed, not held.
EVAL_BARS = {"success_rate": 0.02, "all_success_rate": 0.04, "gate_success_rate": 0.02}
# eval_stats.csv's columns, as the JAX package's cli/eval.py writes them
JAX_EVAL_COLUMNS = ["episode", "ep_rew", "success_frac", "time_mean", "time_stddev",
                    "dist_mean", "dist_stddev", "agent_collisions", "conformance",
                    "spacing_violations"]


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

    def random_graphs(B, E, max_edge, gen):
        node = torch.randn((B, E, 8), generator=gen, device=dev)
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
            checks.append({"case": name, "E": E, "B": B, "max_abs_err": err,
                           **tol, **f64, "two_launches_identical": identical,
                           "prefix_alone": prefix, "ok": ok, **conf})
            if not ok:
                emit({"phase": "kernel", "checks": checks})
                raise AssertionError(f"kernel disagrees with the plain version: {name}")
            max_err = max(max_err, err)

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
            bwd_checks.append({"case": name, "E": E, "B": B, "max_abs_err": err, "finite": finite,
                               "two_launches_identical": identical,
                               "ok": ok, "relu_graphs_set_aside": int(aside.sum().item()),
                               "all_graphs_kept": kept,
                               "graphs_off_f64": graphs_off_f64,
                               "worst_leaf": rows.index(worst), **worst, **conf,
                               "leaves": rows if not ok else len(rows)})
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
    with torch.no_grad():
        for name, (ga, gc), c, nd, ad, tol in (
                ("rollout launch batch, random graphs, relu", (actor_gnn, critic_gnn), cfg,
                 rand_node, rand_adj, KERNEL_TOL),
                ("update batch, relu", (actor_gnn, critic_gnn), cfg, upd_node, upd_adj,
                 KERNEL_TOL),
                ("ragged B, tanh", tanh_pair, tcfg, ragged_node, ragged_adj, KERNEL_TOL),
                ("edgeless graphs, relu", (actor_gnn, critic_gnn), cfg, ragged_node, edgeless,
                 KERNEL_TOL),
                ("E=20, tanh", wide_pair, tcfg, wide_node, wide_adj, WIDE_TOL)):
            E, B = nd.shape[1], nd.shape[0]
            src_a, adj_T = transposed(ga, nd, ad)
            src_c, _ = transposed(gc, nd, ad)
            args, kp_a, kp_c, fa, fc = dual_args(c, E, src_a.shape[0] // E, ga, gc)
            got = gnn_trunk.gnn_trunk_dual_forward(*args, kp_a, kp_c, src_a, src_c, adj_T)
            want = gnn_trunk.gnn_trunk_dual_forward_plain(*args, fa, fc, src_a, src_c, adj_T)
            exact = gnn_trunk.gnn_trunk_dual_forward_plain(*args, fa, fc, src_a, src_c, adj_T,
                                                           compute_dtype=torch.float64)
            single = (gnn_trunk.gnn_trunk_forward(*args, kp_a, src_a, adj_T),
                      gnn_trunk.gnn_trunk_forward(*args, kp_c, src_c, adj_T))
            torch.cuda.synchronize()
            err = max((k - p).abs().max().item() for k, p in zip(got, want))
            f64 = [forward_vs_f64(k, p, x, tol is WIDE_TOL) for k, p, x in zip(got, want, exact)]
            ok = all(bool(torch.isfinite(k).all()) and torch.allclose(k, p, **tol)
                     for k, p in zip(got, want)) and all(f[1] for f in f64)
            dual_fwd_checks.append({
                "case": name, "E": E, "B": B, "max_abs_err": err, **tol,
                **{key: [f[0][key] for f in f64] for key in f64[0][0]},
                "vs_two_single_launches_max_abs": max(
                    (k - s1).abs().max().item() for k, s1 in zip(got, single)),
                "ok": ok, **gnn_trunk.dual_kernel_config(E, args[1], args[2], kp_a.F1, args[3],
                                                         c.embed_layer_n, c.gnn_layer_n)})
            if not ok:
                emit({"phase": "dual", "forward_checks": dual_fwd_checks})
                raise AssertionError(f"dual forward kernel disagrees with the plain version: {name}")
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

        # timing at the update's shape (76,800 graphs, E = 6, relu)
        E = ep.num_entities
        src_a, adj_T = transposed(actor_gnn, upd_node, upd_adj)
        src_c, _ = transposed(critic_gnn, upd_node, upd_adj)
        Ds = src_a.shape[0] // E
        args, kp_a, kp_c, fa, fc = dual_args(cfg, E, Ds, actor_gnn, critic_gnn)
        out_a, out_c = (torch.empty((E * args[3], B_UPD), device=dev) for _ in range(2))
        dual_fwd_ms = time_ms(torch, lambda: gnn_trunk.launch_dual_kernel(
            *args, kp_a, kp_c, src_a, src_c, adj_T, out_a, out_c), reps=10, hide_host=True)
        two_fwd_ms = time_ms(torch, lambda: (
            gnn_trunk.launch_kernel(*args, kp_a, src_a, adj_T, out_a),
            gnn_trunk.launch_kernel(*args, kp_c, src_c, adj_T, out_c)), reps=10, hide_host=True)
        plain_dual_fwd_ms = time_ms(torch, lambda: gnn_trunk.gnn_trunk_dual_forward_plain(
            *args, fa, fc, src_a, src_c, adj_T), reps=5, warmup=1)
        g_a, g_c = (torch.randn((E * args[3], B_UPD), generator=gen, device=dev)
                    for _ in range(2))
        n = kp_a.blob.numel()
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
        dwork = gnn_trunk.dual_work(E, Ds, args[2], kp_a.F1, args[3], cfg.embed_layer_n,
                                    cfg.gnn_layer_n, B_UPD, upd_edges, n)
        dbwork = gnn_trunk.dual_bwd_work(E, Ds, args[2], kp_a.F1, args[3], cfg.embed_layer_n,
                                         cfg.gnn_layer_n, B_UPD, upd_edges, n)
    dual_fwd_bound, dual_fwd_by = bound(dwork)
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
        dual_path()
        torch.cuda.synchronize()
    names = [(e.key, e.count) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    count = lambda pattern: sum(c for k, c in names if re.search(pattern, k))
    # the forward kernel is one template over the number of trunks: its
    # dual instance is gnn_trunk_fwd_kernel<2, ...> (mangled ...ILi2E...)
    profiled = {"gnn_trunk_fwd_kernel<2>": count(r"gnn_trunk_fwd_kernel(<2\b|ILi2E)"),
                "gnn_trunk_dual_bwd_kernel": count("gnn_trunk_dual_bwd_kernel"),
                "sum_rows_kernel": count("sum_rows_kernel"),
                "single trunk kernels": count("gnn_trunk_fwd_panel_kernel")
                + count("gnn_trunk_bwd_kernel")}
    if list(profiled.values()) != [1, 1, 1, 0]:
        raise AssertionError(f"the dual path's profile counts {profiled}: {names}")
    emit({"phase": "dual", "kernels": ["gnn_trunk_dual_fwd", "gnn_trunk_dual_bwd"],
          "forward_checks": dual_fwd_checks, "backward_checks": dual_bwd_checks,
          "B": B_UPD, "E": E, "edges": upd_edges,
          "forward": {"ms": dual_fwd_ms, "two_single_ms": two_fwd_ms,
                      "plain_ms": plain_dual_fwd_ms, "bound_ms": dual_fwd_bound,
                      "bound_by": dual_fwd_by, **dwork,
                      **gnn_trunk.dual_kernel_config(E, Ds, args[2], kp_a.F1, args[3],
                                                     cfg.embed_layer_n, cfg.gnn_layer_n)},
          "backward": {"ms": dual_bwd_ms, "two_single_ms": two_bwd_ms,
                       "plain_ms": plain_dual_bwd_ms, "bound_ms": dual_bwd_bound,
                       "bound_by": dual_bwd_by, **dbwork, **dconf},
          "path_launches": {"dual_fwd": path_launches[2], "dual_bwd": path_launches[3],
                            "single": path_launches[:2]},
          "profiled_kernels": profiled,
          "ptxas": {k: built[k]["ptxas"] for k in ("gnn_trunk_dual_fwd", "gnn_trunk_dual_bwd")},
          "library_ms": None, "library_note": "no PyTorch call computes either trunk"})

    # ---------------------------------------------------------------- v2
    # the trunk forward in the v2 formulation (make_gnn_forward_v2), held
    # against its plain version and against the trunk forward kernel (row 1
    # of the kernel table); nothing routes it, as in the JAX package
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

    def v2_vs_row1(gnn, c, nd, ad, tol):
        """The v2 kernel against the v2 plain version and against row 1's
        kernel on one input, each at ``tol`` and the float64 criterion."""
        src_T, adj_T = transposed(gnn, nd, ad)
        E = nd.shape[1]
        args = trunk_args(c, E, src_T.shape[0] // E)
        flat2 = v2_flat(gnn, c, E)
        got = gnn_trunk_v2.gnn_forward_v2(*args, flat2, src_T, adj_T)
        want = gnn_trunk_v2.gnn_forward_v2_plain(*args, flat2, src_T, adj_T)
        exact = gnn_trunk_v2.gnn_forward_v2_plain(*args, flat2, src_T, adj_T,
                                                  compute_dtype=torch.float64)
        row1 = gnn_trunk.gnn_trunk_forward(*args, gnn.kernel_params(), src_T, adj_T)
        torch.cuda.synchronize()
        wide = tol is WIDE_TOL
        f64, f64_ok = forward_vs_f64(got, want, exact, wide)
        f64_r1, r1_ok = forward_vs_f64(got, row1, exact, wide)
        ok = (bool(torch.isfinite(got).all()) and torch.allclose(got, want, **tol) and f64_ok
              and torch.allclose(got, row1, **tol) and r1_ok)
        return {"E": E, "B": nd.shape[0], "max_abs_err": (got - want).abs().max().item(),
                "vs_row1_max_abs_err": (got - row1).abs().max().item(), **tol, **f64,
                "row1_vs_f64": f64_r1["plain_vs_f64"],
                "row1_vs_f64_rel_l2": f64_r1["plain_vs_f64_rel_l2"], "ok": ok,
                **gnn_trunk_v2.v2_config(*args[:6])}

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

        # timing at the rollout's launch shape and the update's (E = 6, relu)
        gnn = params.actor.gnn_base
        E = ep.num_entities
        v2_timing = {}
        for nd, ad in ((rand_node, rand_adj), (upd_node, upd_adj)):
            src_T, adj_T = transposed(gnn, nd, ad)
            B = nd.shape[0]
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
                            "edges": v2_edges, "v2_param_floats": n_v2, **v2_w}

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
    v2_ms = v2_timing[B_roll]
    emit({"phase": "v2", "kernel": "gnn_forward_v2", "checks": v2_checks,
          "timing": list(v2_timing.values()), "path_launches": v2_path_launches[-1],
          "zero_blocks": "skipped: the kernel reads only the diagonal blocks of the v2 tuple",
          "ptxas": built["gnn_forward_v2"]["ptxas"], "library_ms": None,
          "library_note": "no PyTorch call computes the trunk"})

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
    prof_steps = 5
    prof_runner = Runner(env_params=ep, policy=policy, trainer=rollout_trainer,
                         n_rollout_threads=N_ENVS, episode_length=prof_steps)
    pc = prof_runner.init_carry(SEED + 4)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        tw = time.perf_counter()
        prof_runner.collect(ts, pc)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tw) * 1e3
    avg = prof.key_averages()
    dev_evts = [e for e in avg if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in dev_evts)
    n_kern = sum(e.count for e in dev_evts)
    trunk_us = sum(e.self_device_time_total for e in dev_evts if "gnn_trunk_fwd" in e.key)
    launch_us = sum(e.self_cpu_time_total for e in avg if e.key == "cudaLaunchKernel")
    # per step of the window (its one bootstrap critic call is spread over
    # them); the busy share divides the device time by the unprofiled step
    dev_ms_step = dev_us / 1e3 / prof_steps
    profile = {
        "steps": prof_steps, "profiled_wall_ms_per_step": wall_ms / prof_steps,
        "device_ms_per_step": dev_ms_step,
        "device_busy_share": dev_ms_step / (seconds * 1e3 / STEPS) if dev_us > 0 else None,
        "kernels_per_step": n_kern / prof_steps,
        "trunk_kernel_ms_per_step": trunk_us / 1e3 / prof_steps,
        "cudaLaunchKernel_host_ms_per_step": launch_us / 1e3 / prof_steps,
    }
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

    # where the update's time goes: a collect, then a 2-epoch update
    # unprofiled and profiled on its buffer
    prof_epochs = 2
    prof_trainer = GRMAPPOTrainer(policy, ppo_epoch=prof_epochs, data_chunk_length=CHUNK)
    t0 = time.perf_counter()
    tcarry, pbuf, _ = train_runner.collect(tts, tcarry)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prof_trainer.train(tts, pbuf)
    torch.cuda.synchronize()
    epoch_ms = (time.perf_counter() - t0) * 1e3 / prof_epochs
    with torch.profiler.profile(activities=acts) as prof:
        tw = time.perf_counter()
        prof_trainer.train(tts, pbuf)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - tw) * 1e3
    avg = prof.key_averages()
    dev_evts = [e for e in avg if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in dev_evts)
    by = lambda key: sum(e.self_device_time_total for e in dev_evts if key in e.key)
    dev_ms_epoch = dev_us / 1e3 / prof_epochs
    top = sorted(dev_evts, key=lambda e: -e.self_device_time_total)[:8]
    update_profile = {
        "epochs": prof_epochs, "unprofiled_wall_ms_per_epoch": epoch_ms,
        "profiled_wall_ms_per_epoch": prof_wall_ms / prof_epochs,
        "device_ms_per_epoch": dev_ms_epoch,
        "device_busy_share": dev_ms_epoch / epoch_ms if dev_us > 0 else None,
        "kernels_per_epoch": sum(e.count for e in dev_evts) / prof_epochs,
        "trunk_fwd_kernel_ms_per_epoch": by("gnn_trunk_fwd") / 1e3 / prof_epochs,
        "trunk_bwd_kernel_ms_per_epoch": by("gnn_trunk_bwd") / 1e3 / prof_epochs,
        "cudaLaunchKernel_host_ms_per_epoch": sum(
            e.self_cpu_time_total for e in avg if e.key == "cudaLaunchKernel") / 1e3 / prof_epochs,
        "top_device_ms_per_epoch": {e.key[:60]: e.self_device_time_total / 1e3 / prof_epochs
                                    for e in top},
        "collect_seconds": collect_s,
    }

    # one update, card (kernels) vs CPU (plain), from the same buffer and
    # weights, with tanh activations everywhere
    tanh_all = ModelConfig(max_edge_dist=cfg.max_edge_dist, use_relu=False,
                           embed_use_relu=False, gnn_use_relu=False)
    sides = {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        pol = GRMAPPOPolicy(tanh_all, dims, device=d)
        tr = GRMAPPOTrainer(pol, ppo_epoch=1, data_chunk_length=CHUNK)
        sides[side] = (tr, tr.init_state(SEED + 7))
    tr_c, ts_c = sides["card"]
    cmp_runner = Runner(env_params=ep, policy=tr_c.policy, trainer=tr_c,
                        n_rollout_threads=CMP_ENVS, episode_length=STEPS)
    _, buf_c, _ = cmp_runner.collect(ts_c, cmp_runner.init_carry(SEED + 7))
    buf_h = dataclasses.replace(buf_c, **{
        f.name: getattr(buf_c, f.name).cpu() for f in dataclasses.fields(buf_c)
        if getattr(buf_c, f.name) is not None})
    first = {}
    for side, buf in (("card", buf_c), ("cpu", buf_h)):
        tr, st = sides[side]
        batch = tr._time_major(tr.chunks(st, buf))
        vn = vn_update(st.vn, batch["returns"].reshape(-1, 1))
        named = [(f"{m}.{n}", p) for m in ("actor", "critic")
                 for n, p in getattr(st.params, m).named_parameters()]
        total, _ = tr.loss(st.params, vn, batch)
        grads = torch.autograd.grad(total, [p for _, p in named], allow_unused=True)
        first[side] = {n: (torch.zeros_like(p) if gr is None else gr).detach().cpu()
                       for (n, p), gr in zip(named, grads)}
    grad_err, worst_ratio = {}, 0.0
    for n, want in first["cpu"].items():
        err = (first["card"][n] - want).abs().max().item()
        bar = GRAD_RTOL * want.abs().max().item() + GRAD_ATOL
        worst_ratio = max(worst_ratio, err / bar)
        grad_err[n] = err
        if err > bar:
            raise AssertionError(f"card and CPU update gradients disagree on {n}: {err} > {bar}")
    infos = {side: {k: v.item() for k, v in tr.train(st, buf_c if side == "card" else buf_h)[1].items()}
             for side, (tr, st) in sides.items()}
    for k, want in infos["cpu"].items():
        if abs(infos["card"][k] - want) > LOSS_RTOL * abs(want) + LOSS_ATOL:
            raise AssertionError(f"card and CPU update disagree on {k}: {infos['card'][k]} vs {want}")
    mean_of = lambda key: statistics.mean(e[key] for e in episodes)
    emit({"phase": "train", "envs": TRAIN_ENVS, "agents": ep.num_agents, "steps": STEPS,
          "ppo_epoch": PPO_EPOCH, "num_mini_batch": 1, "data_chunk_length": CHUNK,
          "graphs_per_trunk_call": B_UPD, "episodes": episodes,
          "seconds_per_episode": mean_of("seconds"),
          "env_steps_per_s": mean_of("env_steps_per_s"),
          "weight_tensors_changed": changed, "update_profile": update_profile,
          "card_vs_cpu": {"envs": CMP_ENVS, "first_epoch_grad_worst_ratio_to_bar": worst_ratio,
                          "first_epoch_grad_max_abs_err": max(grad_err.values()),
                          "train_info_card": infos["card"], "train_info_cpu": infos["cpu"]}})

    # ---------------------------------------------------------------- cli
    # the train entry point as a user runs it: three flagship episodes with
    # in-training evaluation, then the last one again, resumed from its checkpoint
    from contracts_marl_aam_corridors_tpu_torch.cli import train as cli_train
    from contracts_marl_aam_corridors_tpu_torch.config.flags import parse_all
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
    # the shipped july checkpoint (model_weights/july/unicycle ckpt_1561,
    # converted by scripts/orbax_to_torch.py) under the JAX package's batched
    # protocol, held to the JAX package's evaluation of it (jax_eval.json,
    # made on the CPU with the same flags); its trained trunks through v2
    # and through the trunk forward kernel
    from contracts_marl_aam_corridors_tpu_torch.tools.eval_batched import run_side
    from contracts_marl_aam_corridors_tpu_torch.utils.checkpoint import arch_act_flags

    ckpt_dir = ROOT / JULY_CKPT
    with open(ckpt_dir / "jax_eval.json") as f:
        jax_ref = json.load(f)
    act_flags = arch_act_flags(str(ckpt_dir))
    ck_args = parse_all(jax_ref["argv"])
    for k, v in act_flags.items():  # the run's activation flags, as the JAX side took them
        setattr(ck_args, k, v)
    ck_env, _, ck_trainer, ck_runner = cli_train.build(ck_args)
    ck_ts, ck_episode = restore_checkpoint(str(ckpt_dir), ck_trainer.init_state(SEED))
    for f in all_counters:
        f.launches = 0
    t0 = time.perf_counter()
    ck_row = run_side(ck_ts, ck_runner, n_eval=EVAL_BATCH, seeds=EVAL_SEEDS)
    torch.cuda.synchronize()
    ck_seconds = time.perf_counter() - t0
    ck_launches = [f.launches for f in all_counters]
    want = [EVAL_SEEDS * ck_env.episode_length, 0, 0, 0, 0]
    if ck_launches != want:
        raise AssertionError(f"the checkpoint's evaluation launched (fwd, bwd, dual fwd, dual "
                             f"bwd, v2) {ck_launches}, expected {want}")
    if len(jax_ref["rows"]) != EVAL_SEEDS or jax_ref["rows"][0]["seed"] != 100:
        raise AssertionError("jax_eval.json holds another protocol")
    vs_jax = {k: {"port": ck_row[k], "jax": jax_ref["mean"][k],
                  "diff": ck_row[k] - jax_ref["mean"][k], "bar": EVAL_BARS.get(k)}
              for k in ("success_rate", "all_success_rate", "gate_success_rate",
                        "num_agent_collisions")}
    failed = [k for k, v in vs_jax.items() if v["bar"] is not None and abs(v["diff"]) > v["bar"]]

    # the trained trunks on the graphs of the first eval step (seed 100)
    ck_trunks = []
    with torch.no_grad():
        _, ts0 = env_mod.reset(ck_env, EVAL_BATCH, torch.Generator(device=dev).manual_seed(100),
                               dev)
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
                *args, nets._flatten_gnn_params(gnn, c.embed_layer_n, c.gnn_layer_n), src_T,
                adj_T, compute_dtype=torch.float64)
            torch.cuda.synchronize()
            f64, f64_ok = forward_vs_f64(got, row1, exact, False)
            ok = (bool(torch.isfinite(got).all()) and torch.allclose(got, row1, **KERNEL_TOL)
                  and f64_ok)
            ck_trunks.append({"trunk": side, "B": B * N, "E": E,
                              "acts": [c.embed_use_relu, c.gnn_use_relu],
                              "v2_vs_row1_max_abs_err": (got - row1).abs().max().item(),
                              "v2_vs_f64": f64["kernel_vs_f64"],
                              "row1_vs_f64": f64["plain_vs_f64"], **KERNEL_TOL, "ok": ok})
    emit({"phase": "checkpoint", "checkpoint": str(JULY_CKPT), "episode": ck_episode,
          "argv": jax_ref["argv"], "act_flags": act_flags,
          "envs": EVAL_BATCH, "seeds": EVAL_SEEDS, "seconds": ck_seconds, "port": ck_row,
          "vs_jax": vs_jax, "launches": ck_launches, "trunks": ck_trunks,
          "jax_versions": jax_ref["versions"]})
    if failed:
        raise AssertionError(f"the port's evaluation of the checkpoint misses the bars: {failed}")
    if not all(t["ok"] for t in ck_trunks):
        raise AssertionError("the trained trunks differ through v2 and the trunk forward kernel, "
                             "or v2 lies further from float64")

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

    # ---------------------------------------------------------------- summary
    emit({"kernels": [{
        "name": "gnn_trunk_fwd", "route": "cuda",
        "source": f"{PACKAGE}/csrc/gnn_trunk_fwd.cu",
        "replaces": "contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:299",
        "launches": episodes[-1]["forward_launches"], "rollout_launches": launches,
        "eval_launches": eval_launches, "checkpoint_eval_launches": ck_launches[0],
        "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "ms_by_graphs": {r["B"]: r["ms"] for r in sizes},
        "bound_ms_by_graphs": {r["B"]: r["bound_ms"] for r in sizes},
        "library_ms": None,
    }, {
        "name": "gnn_trunk_bwd", "route": "cuda",
        "source": f"{PACKAGE}/csrc/gnn_trunk_bwd.cu",
        "replaces": "contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:594",
        "launches": episodes[-1]["backward_launches"], "max_abs_err": bwd_max_err,
        "ms": bwd_ms, "plain_ms": plain_bwd_ms, "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by, "library_ms": None,
    }, {
        "name": "gnn_trunk_dual_fwd", "route": "cuda",
        "source": f"{PACKAGE}/csrc/gnn_trunk_dual_fwd.cu",
        "replaces": "contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:703",
        "launches": path_launches[2], "max_abs_err": dual_fwd_err,
        "ms": dual_fwd_ms, "two_single_ms": two_fwd_ms, "plain_ms": plain_dual_fwd_ms,
        "bound_ms": dual_fwd_bound, "bound_by": dual_fwd_by, "library_ms": None,
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
        "dense_bound_ms": v2_ms["dense_bound_ms"], "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
