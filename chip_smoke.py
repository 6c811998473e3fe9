#!/usr/bin/env python3
"""Drive the torch port's july rollout, evaluation and PPO training on one
CUDA card.

    python3 chip_smoke.py

Builds the port's kernels (``csrc/gnn_trunk_fwd.cu`` and
``csrc/gnn_trunk_bwd.cu``, one ``nvcc`` each for sm_90a, in parallel), holds
each against its plain torch version on the card, runs ``Runner.collect`` at
4096 envs x 25 steps, ``Runner.eval_episode`` at 1024 envs and
``Runner.train_episode`` at 1024 envs x 25 steps with 15 PPO epochs, all at
the default model's full width, and checks that every GNN trunk forward and
backward of those paths went through the kernels.  Prints one JSON line per
phase (device, build, kernel, backward, rollout, eval, train, kernels), then
the card's name and power limit as ``nvidia-smi`` gives them, then
``{"ok": true, "device": {...}}`` as the last line.  Any failed check raises,
so the script exits non-zero without that line.  Without a CUDA device, or
without the port's package beside it, it exits non-zero and prints no
result.  It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = "contracts_marl_aam_corridors_tpu_torch"

N_ENVS, STEPS, EVAL_ENVS = 4096, 25, 1024
# the flagship training episode: 1024 envs x 25 steps x 3 agents = 76,800
# graphs per trunk call of the update, 15 epochs of one minibatch
TRAIN_ENVS, PPO_EPOCH, CHUNK = 1024, 15, 10
TRAIN_EPISODES = 3
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
# package (tests/test_models.py:529)
WIDE_TOL = dict(rtol=2e-4, atol=2e-5)
NET_TOL = dict(rtol=2e-4, atol=2e-5)
# Backward kernel vs plain backward, per leaf (each parameter, dsrc, dadj):
# with tanh the JAX package's gradient bar |k - p| <= 1e-4 max|p| + 1e-5
# (tests/test_models.py:611-613); where the float32 plain version is itself
# further than that from a float64 evaluation, the kernel must be no further
# from the float64 evaluation than twice the plain version is.  With relu,
# rounding flips subgradients at zero, so the relative L2 error per leaf is
# held at 1e-4; where the float32 plain version is itself further than that
# from the float64 evaluation, the kernel must be within 1e-4 of the float64
# evaluation instead.  One flip is enough to need that: at 76,800 random
# graphs a single relu pre-activation within float32 rounding of zero moves
# its graph's gradient by tens of percent and every leaf's relative L2 by
# some 1e-4 (graphs_off_f64 counts the graphs so moved).
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
RELU_REL_L2 = 1e-4
# Card vs CPU update: losses and norms at rtol 1e-4.  The first epoch's
# policy loss is minus the mean normalized advantage, zero up to rounding, so
# an atol of 1e-6 stands beside the rtol.
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6
# H100 SXM published peaks (NVIDIA data sheet, dense): FP32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=30, warmup=3) -> float:
    """Median over ``reps`` of one call's device time, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    from contracts_marl_aam_corridors_tpu_torch.ops import gnn_trunk

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

        checks, max_err = [], 0.0
        for name, gnn, c, nd, ad, tol in cases:
            src_T, adj_T = transposed(gnn, nd, ad)
            E = nd.shape[1]
            args = trunk_args(c, E, src_T.shape[0] // E)
            flat = nets._flatten_gnn_params(gnn, c.embed_layer_n, c.gnn_layer_n)
            got = gnn_trunk.gnn_trunk_forward(*args, gnn.kernel_params(), src_T, adj_T)
            want = gnn_trunk.gnn_trunk_forward_plain(*args, flat, src_T, adj_T)
            exact = gnn_trunk.gnn_trunk_forward_plain(*args, flat, src_T, adj_T,
                                                      compute_dtype=torch.float64)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            k64 = (got - exact).abs().max().item()
            p64 = (want - exact).abs().max().item()
            ok = (bool(torch.isfinite(got).all()) and torch.allclose(got, want, **tol)
                  and k64 <= 2 * p64)
            conf = gnn_trunk.kernel_config(E, args[1], args[2], c.embed_hidden_size, args[3],
                                           c.embed_layer_n, c.gnn_layer_n)
            checks.append({"case": name, "E": E, "B": nd.shape[0], "max_abs_err": err,
                           **tol, "kernel_vs_f64": k64, "plain_vs_f64": p64, "ok": ok,
                           **conf})
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
            *args, kp, src_T, adj_T, out))
        # the wrapper as the model calls it: checks, output allocation, launch
        wrapper_ms = time_ms(torch, lambda: gnn_trunk.gnn_trunk_forward(
            *args, gnn.kernel_params(), src_T, adj_T))
        plain_ms = time_ms(torch, lambda: gnn_trunk.gnn_trunk_forward_plain(
            *args, flat, src_T, adj_T))
        n_edges = int(((adj_T > 0) & (adj_T < cfg.max_edge_dist)).sum().item())
        work = gnn_trunk.trunk_work(E, args[1], args[2], kp.F1, args[3], cfg.embed_layer_n,
                                    cfg.gnn_layer_n, src_T.shape[1], n_edges, kp.blob.numel())
    ops_ms = work["flops"] / PEAK_FP32_FLOPS * 1e3
    bytes_ms = work["bytes"] / PEAK_BYTES_PER_S * 1e3
    bound_ms, bound_by = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    timing = {"B": src_T.shape[1], "E": E, "ms": kernel_ms, "wrapper_ms": wrapper_ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
              "flops": work["flops"], "bytes": work["bytes"], "edges": n_edges,
              "library_ms": None}
    emit({"phase": "kernel", "kernel": "gnn_trunk_fwd", "checks": checks, **timing})

    # ---------------------------------------------------------------- backward
    def grad_leaves(c, Ds, dblob, dsrc, dadj):
        flat = gnn_trunk.unpack_blob(gnn_trunk.KernelParams(dblob, c.embed_hidden_size), Ds,
                                     c.gnn_num_heads, c.gnn_hidden_size, c.embed_layer_n,
                                     c.gnn_layer_n)
        return list(flat) + [dsrc, dadj]

    def compare_leaves(got, want, exact, relu):
        """Per leaf (each parameter, dsrc, dadj): the JAX gradient bar (tanh)
        or the relative L2 error (relu); see GRAD_RTOL and RELU_REL_L2."""
        rows = []
        for k, p, x in zip(got, want, exact):
            k, p, x = k.double(), p.double(), x.double()
            err = (k - p).abs().max().item()
            if relu:
                rel = lambda a, b: ((a - b).norm() / b.norm().clamp(min=1e-300)).item()
                r = rel(k, p)
                r64k, r64p = rel(k, x), rel(p, x)
                ok = r <= RELU_REL_L2 or (r64p > RELU_REL_L2 and r64k <= RELU_REL_L2)
                rows.append({"max_abs_err": err, "rel_l2": r, "kernel_vs_f64_rel_l2": r64k,
                             "plain_vs_f64_rel_l2": r64p, "ok": ok})
            else:
                bar = GRAD_RTOL * p.abs().max().item() + GRAD_ATOL
                k64, p64 = (k - x).abs().max().item(), (p - x).abs().max().item()
                ok = err <= bar or (p64 > bar and k64 <= 2 * p64)
                rows.append({"max_abs_err": err, "bar": bar, "kernel_vs_f64": k64,
                             "plain_vs_f64": p64, "ok": ok})
        return rows

    bwd_checks, bwd_max_err = [], 0.0
    with torch.no_grad():
        wide_tanh = nets.GNNBase(tcfg, 8, "node")
        wide_tanh.init_(torch.Generator().manual_seed(SEED + 2))
        wide_tanh = wide_tanh.to(dev)
        bwd_cases = [
            ("update batch, tanh", tanh_gnn, tcfg, upd_node, upd_adj),
            ("update batch, relu", params.actor.gnn_base, cfg, upd_node, upd_adj),
            ("ragged B, tanh", tanh_gnn, tcfg, ragged_node, ragged_adj),
            ("edgeless graphs, tanh", tanh_gnn, tcfg, ragged_node, edgeless),
            ("E=20, tanh", wide_tanh, tcfg, wide_node, wide_adj),
        ]
        for name, gnn, c, nd, ad in bwd_cases:
            src_T, adj_T = transposed(gnn, nd, ad)
            E, B = nd.shape[1], nd.shape[0]
            Ds = src_T.shape[0] // E
            args = trunk_args(c, E, Ds)
            g = torch.randn((E * c.gnn_hidden_size, B), generator=gen, device=dev)
            kp = gnn.kernel_params()
            got = grad_leaves(c, Ds, *gnn_trunk.gnn_trunk_backward(*args, kp, src_T, adj_T, g))
            flat = gnn_trunk.unpack_blob(kp, Ds, c.gnn_num_heads, c.gnn_hidden_size,
                                         c.embed_layer_n, c.gnn_layer_n)
            dflat, ds, da = gnn_trunk.gnn_trunk_backward_plain(*args, flat, src_T, adj_T, g)
            want = list(dflat) + [ds, da]
            dflat, ds, da = gnn_trunk.gnn_trunk_backward_plain(
                *args, flat, src_T, adj_T, g, compute_dtype=torch.float64)
            exact = list(dflat) + [ds, da]
            torch.cuda.synchronize()
            finite = all(bool(torch.isfinite(t).all()) for t in got)
            rows = compare_leaves(got, want, exact, relu=c.gnn_use_relu)
            # graphs whose dsrc lies further than 1e-3 of its largest entry
            # from float64: where a relu pre-activation is within float32
            # rounding of zero, its subgradient flips and that one graph's
            # gradient jumps; the other graphs' distance shows the rest
            size = exact[-2].abs().amax(0)
            off = lambda a: (a.double() - exact[-2]).abs().amax(0) > 1e-3 * size
            keep = ~off(want[-2])
            graphs_off_f64 = {
                "kernel": int(off(got[-2]).sum().item()), "plain": int((~keep).sum().item()),
                "plain_dsrc_rel_l2_other_graphs": ((want[-2].double() - exact[-2])[:, keep].norm()
                                                   / exact[-2][:, keep].norm()).item()
                if keep.any() else None}
            ok = finite and all(r["ok"] for r in rows)
            err = max(r["max_abs_err"] for r in rows)
            conf = gnn_trunk.backward_config(E, Ds, args[2], c.embed_hidden_size, args[3],
                                             c.embed_layer_n, c.gnn_layer_n, B)
            worst = max(rows, key=lambda r: r.get("rel_l2", r.get("max_abs_err", 0) / r.get("bar", 1)))
            bwd_checks.append({"case": name, "E": E, "B": B, "max_abs_err": err, "finite": finite,
                               "ok": ok, "graphs_off_f64": graphs_off_f64,
                               "worst_leaf": rows.index(worst), **worst, **conf,
                               "leaves": rows if not ok else len(rows)})
            del got, want, exact, dflat, ds, da
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
            *args, kp, src_T, adj_T, g, dsrc, dadj, dblob, partial), reps=10)
        upd_fwd_ms = time_ms(torch, lambda: gnn_trunk.launch_kernel(
            *args, kp, src_T, adj_T, torch.empty((E * args[3], B_UPD), device=dev)), reps=10)

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
    b_ops_ms = bwork["flops"] / PEAK_FP32_FLOPS * 1e3
    b_bytes_ms = bwork["bytes"] / PEAK_BYTES_PER_S * 1e3
    bwd_bound_ms, bwd_bound_by = ((b_ops_ms, "operations") if b_ops_ms >= b_bytes_ms
                                  else (b_bytes_ms, "bytes"))
    emit({"phase": "backward", "kernel": "gnn_trunk_bwd", "checks": bwd_checks,
          "B": B_UPD, "E": E, "ms": bwd_ms, "forward_kernel_ms": upd_fwd_ms,
          "gnn_trunk_fwd_plus_bwd_ms": fwd_bwd_ms, "plain_ms": plain_bwd_ms,
          "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by, "flops": bwork["flops"],
          "bytes": bwork["bytes"], "edges": upd_edges, **conf,
          "ptxas": built["gnn_trunk_bwd"]["ptxas"], "library_ms": None,
          "library_note": "no PyTorch call computes the trunk's vjp"})

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

    # ---------------------------------------------------------------- summary
    emit({"kernels": [{
        "name": "gnn_trunk_fwd", "route": "cuda",
        "source": f"{PACKAGE}/csrc/gnn_trunk_fwd.cu",
        "replaces": "contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:299",
        "launches": episodes[-1]["forward_launches"], "rollout_launches": launches,
        "eval_launches": eval_launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "gnn_trunk_bwd", "route": "cuda",
        "source": f"{PACKAGE}/csrc/gnn_trunk_bwd.cu",
        "replaces": "contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:594",
        "launches": episodes[-1]["backward_launches"], "max_abs_err": bwd_max_err,
        "ms": bwd_ms, "plain_ms": plain_bwd_ms, "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by, "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
