"""The trunk forward kernel (row 1) against the parent tree's and v2, on one
card.

    python scripts/trunk_fwd_ab.py --parent <root of the parent tree>

Builds this tree's kernel as the port does and, from the parent tree (unpack
``git archive <parent>`` into a directory that ``.gitignore`` lists), that
tree's ``gnn_trunk_fwd.cu``, whose C function takes the same arguments.  On
random graphs of the flagship model (E = 6, relu, random weights from a seed)
at one graph (the latency of one graph's work, which bounds a launch whose
tiles all fit on the card at once) and at the launch sizes of the paths
(768, 3,072, 12,288 and 76,800 graphs) it prints, one JSON line a size, each
kernel's largest and relative L2 distance from a float64 evaluation over the
float32 plain version's (the forward bar is 2), and in two rounds, the
second in reverse order, beside v2's (``gnn_forward_v2``), its CUDA-event
median ms on the device alone (``ms``) and of a call on an idle card, the
host's submission included (``call_ms``); and this tree's launch plan.
Then the card's name and power limit.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SIZES = (1, 768, 3072, 12288, 76800)
SEED = 0


def time_ms(torch, fn, reps=20, warmup=3, hide_host=False) -> float:
    """Median over ``reps`` of one call's time, from CUDA events: with
    ``hide_host`` the device's alone (``torch.cuda._sleep`` keeps the card
    busy, about 1 ms, while the host submits the call), else the call's on
    an idle card, the host's submission included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        if hide_host:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--parent", required=True)
    a = p.parse_args()
    import torch
    from contracts_marl_aam_corridors_tpu_torch.config.physics import vehicle_config
    from contracts_marl_aam_corridors_tpu_torch.envs.types import EnvParams
    from contracts_marl_aam_corridors_tpu_torch.models import ModelConfig, nets
    from contracts_marl_aam_corridors_tpu_torch.ops import gnn_trunk, gnn_trunk_v2

    if not torch.cuda.is_available():
        print("trunk_fwd_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    parent_src = (Path(a.parent).resolve() / "contracts_marl_aam_corridors_tpu_torch" / "csrc"
                  / "gnn_trunk_fwd.cu")
    built = {"row1": gnn_trunk.build("gnn_trunk_fwd"),
             "parent": gnn_trunk.compile_kernel(
                 parent_src, gnn_trunk.BUILD_DIR / "ab" / "libgnn_trunk_fwd_parent.so")}
    gnn_trunk.build("gnn_forward_v2")
    print(json.dumps({"ptxas": {k: b["ptxas"] for k, b in built.items()}}), flush=True)
    parent = ctypes.CDLL(built["parent"]["library"])
    parent.gnn_trunk_fwd.argtypes = gnn_trunk._SIGNATURES["gnn_trunk_fwd"]["gnn_trunk_fwd"]
    parent.gnn_trunk_fwd.restype = ctypes.c_int

    ep = EnvParams(cfg=vehicle_config("air_taxi"))
    cfg = ModelConfig(max_edge_dist=ep.cfg.coordination_range)
    gnn = nets.GNNBase(cfg, ep.node_feat_dim, "node")
    gnn.init_(torch.Generator().manual_seed(SEED))
    gnn = gnn.to(dev)
    E = ep.num_entities
    kp = gnn.kernel_params()
    flat = nets._flatten_gnn_params(gnn, cfg.embed_layer_n, cfg.gnn_layer_n)
    flat2 = gnn_trunk_v2.flatten_gnn_params_v2(gnn.flax_tree(), E, cfg.gnn_num_heads,
                                               cfg.gnn_hidden_size, cfg.embed_layer_n,
                                               cfg.gnn_layer_n)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    B = max(SIZES)
    node = torch.randn((B, E, ep.node_feat_dim), generator=gen, device=dev)
    node[..., -1] = torch.randint(0, 2, (B, E), generator=gen, device=dev).float()
    adj = torch.rand((B, E, E), generator=gen, device=dev) * 2 * cfg.max_edge_dist
    adj = (adj + adj.transpose(1, 2)) / 2
    adj[:, torch.arange(E), torch.arange(E)] = 0.0

    def launch_parent(args, src_T, adj_T, out):
        E_, Ds, H, C, n_embed, n_gnn, med, (er, gr) = args
        rc = parent.gnn_trunk_fwd(src_T.data_ptr(), adj_T.data_ptr(), kp.blob.data_ptr(),
                                  out.data_ptr(), src_T.shape[-1], E_, Ds, H, kp.F1, C, n_embed,
                                  1 + n_gnn, float(med), int(er), int(gr), kp.blob.numel(),
                                  torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the parent's gnn_trunk_fwd returned {rc}")

    with torch.no_grad():
        for n in SIZES:
            src_T = nets._gnn_src_T(gnn, node[:n])
            adj_T = adj[:n].permute(1, 2, 0).reshape(E * E, n).contiguous()
            args = (E, src_T.shape[0] // E, cfg.gnn_num_heads, cfg.gnn_hidden_size,
                    cfg.embed_layer_n, cfg.gnn_layer_n, cfg.max_edge_dist,
                    (cfg.embed_use_relu, cfg.gnn_use_relu))
            want = gnn_trunk.gnn_trunk_forward_plain(*args, flat, src_T, adj_T).double()
            exact = gnn_trunk.gnn_trunk_forward_plain(*args, flat, src_T, adj_T,
                                                      compute_dtype=torch.float64)
            p_max, p_l2 = (want - exact).abs().max().item(), (want - exact).norm().item()
            out = torch.empty((E * cfg.gnn_hidden_size, n), device=dev)
            calls = {"row1": lambda: gnn_trunk.launch_kernel(*args, kp, src_T, adj_T, out),
                     "parent": lambda: launch_parent(args, src_T, adj_T, out),
                     "v2": lambda: gnn_trunk_v2.launch_v2_kernel(*args, flat2, src_T, adj_T, out)}
            row = {"B": n, "vs_f64_over_plain": {}}
            for name in ("row1", "parent"):
                calls[name]()
                torch.cuda.synchronize()
                err = out.double() - exact
                row["vs_f64_over_plain"][name] = {"max": err.abs().max().item() / p_max,
                                                  "rel_l2": err.norm().item() / p_l2}
            reps = 30 if n < 76800 else 10
            ms = {name: [] for name in calls}
            call_ms = {name: [] for name in calls}
            for order in (list(calls), list(reversed(calls))):
                for name in order:
                    ms[name].append(time_ms(torch, calls[name], reps=reps, hide_host=True))
                    call_ms[name].append(time_ms(torch, calls[name], reps=reps))
            row["ms"], row["call_ms"] = ms, call_ms
            row["plan"] = gnn_trunk.kernel_config(E, args[1], args[2], kp.F1, args[3],
                                                  cfg.embed_layer_n, cfg.gnn_layer_n, n)
            print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
