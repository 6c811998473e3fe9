#!/usr/bin/env python3
"""Drive the torch port's july rollout and evaluation on one CUDA card.

    python3 chip_smoke.py

Builds the port's kernel (``csrc/gnn_trunk_fwd.cu``, with ``nvcc`` for
sm_90a), holds it against its plain torch version on the card, runs
``Runner.collect`` at 4096 envs x 25 steps and ``Runner.eval_episode`` at
1024 envs at the default model's full width, and checks that every GNN trunk
call of those paths went through the kernel.  Prints one JSON line per phase
(device, build, kernel, rollout, eval, kernels), then the card's name and
power limit as ``nvidia-smi`` gives them, then
``{"ok": true, "device": {...}}`` as the last line.  Any failed check raises,
so the script exits non-zero without that line.  Without a CUDA device, or
without the port's package beside it, it exits non-zero and prints no
result.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = "contracts_marl_aam_corridors_tpu_torch"

N_ENVS, STEPS, EVAL_ENVS = 4096, 25, 1024
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
    from contracts_marl_aam_corridors_tpu_torch.learner import Runner, TrainState, vn_init
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
    b = gnn_trunk.build()
    emit({"phase": "build", "kernel": "gnn_trunk_fwd", "nvcc_seconds": b["seconds"],
          "library": Path(b["library"]).name, "ptxas": b["ptxas"]})

    # the model, at the default widths of the july configuration
    ep = EnvParams(cfg=vehicle_config("air_taxi"))
    cfg = ModelConfig(max_edge_dist=ep.cfg.coordination_range)
    dims = PolicyDims(ep.obs_dim, ep.obs_dim * ep.num_agents, ep.num_entities,
                      ep.node_feat_dim, ep.num_actions)
    policy = GRMAPPOPolicy(cfg, dims)
    params = policy.init_params(SEED)
    ts = TrainState(params=params, vn=vn_init(torch.float32, dev))

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

    # ---------------------------------------------------------------- rollout
    runner = Runner(env_params=ep, policy=policy, n_rollout_threads=N_ENVS,
                    episode_length=STEPS)
    warm = Runner(env_params=ep, policy=policy, n_rollout_threads=N_ENVS, episode_length=2)
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
    prof_runner = Runner(env_params=ep, policy=policy, n_rollout_threads=N_ENVS,
                         episode_length=prof_steps)
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

    # ---------------------------------------------------------------- summary
    emit({"kernels": [{
        "name": "gnn_trunk_fwd", "route": "cuda",
        "source": f"{PACKAGE}/csrc/gnn_trunk_fwd.cu",
        "replaces": "contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:299",
        "launches": launches, "eval_launches": eval_launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
