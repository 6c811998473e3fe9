"""The trunk backward kernel (row 2) of one tree on one card: its device
time and how far its parameter gradients lie from a float64 evaluation.

    python scripts/trunk_bwd_ab.py --root <tree>

``<tree>`` is this tree (``.``) or another one, such as the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists;
the script imports the port's package from there, builds that tree's
``gnn_trunk_bwd`` kernel and checks that it runs that tree's code.  Run it
once per tree, each in its own process, in the order parent, change,
change, parent, so that drift of the card's clocks shows.  At E = 6 (76,800
graphs, the flagship's update), E = 13 (128,000 graphs, BASELINE config 2's)
and E = 22 (64,000 graphs, 10 agents with 2 walls), on random graphs and
weights of a seed, tanh (two seeds) and relu (one), it prints one JSON line
a case: the median device ms of ten launches (``torch.cuda._sleep`` keeps
the card busy while the host submits each), whether a second launch gives
the same bits, and for the worst parameter leaf its distance from the
float64 plain backward (taken in chunks of 16,000 graphs, summed) over the
JAX gradient bar 1e-4 max|plain| + 1e-5, beside the float32 plain version's
own distance and the kernel's distance from that version.
"""
import argparse
import json
import os
import statistics
import sys

CHUNK = 16000  # graphs of a float64 plain backward at a time
CASES = ((6, 8, 76800), (13, 8, 128000), (22, 13, 64000))  # E, node features, graphs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch

    from contracts_marl_aam_corridors_tpu_torch.config.physics import vehicle_config
    from contracts_marl_aam_corridors_tpu_torch.models import ModelConfig, nets
    from contracts_marl_aam_corridors_tpu_torch.ops import gnn_trunk

    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(gnn_trunk.__file__))))
    if here != root:
        raise SystemExit(f"imported the port from {here}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gnn_trunk.build("gnn_trunk_bwd")

    def dev_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ts = []
        for _ in range(reps):
            torch.cuda._sleep(2_000_000)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1))
        return statistics.median(ts)

    for relu in (False, True):
        cfg = ModelConfig(max_edge_dist=vehicle_config("air_taxi").coordination_range,
                          embed_use_relu=relu, gnn_use_relu=relu)
        for E, F, B in CASES:
            for seed in ((0, 1) if not relu else (0,)):
                gnn = nets.GNNBase(cfg, F, "node")
                gnn.init_(torch.Generator().manual_seed(seed))
                gnn = gnn.to(dev)
                kp = gnn.kernel_params()
                g_ = torch.Generator(device=dev).manual_seed(100 + seed)
                node = torch.randn((B, E, F), generator=g_, device=dev)
                node[..., -1] = torch.randint(0, 4 if F == 13 else 2, (B, E), generator=g_,
                                              device=dev).float()
                adj = torch.rand((B, E, E), generator=g_, device=dev) * 2 * cfg.max_edge_dist
                adj = (adj + adj.transpose(1, 2)) / 2
                adj[:, torch.arange(E), torch.arange(E)] = 0
                with torch.no_grad():
                    src_T = nets._gnn_src_T(gnn, node)
                adj_T = adj.permute(1, 2, 0).reshape(E * E, B).contiguous()
                g = torch.randn((E * cfg.gnn_hidden_size, B), generator=g_, device=dev)
                Ds = src_T.shape[0] // E
                args = (E, Ds, cfg.gnn_num_heads, cfg.gnn_hidden_size, cfg.embed_layer_n,
                        cfg.gnn_layer_n, cfg.max_edge_dist, (relu, relu))
                flat = gnn_trunk.unpack_blob(kp, *args[1:6])
                dblob = gnn_trunk.gnn_trunk_backward(*args, kp, src_T, adj_T, g)[0]
                again = gnn_trunk.gnn_trunk_backward(*args, kp, src_T, adj_T, g)[0]
                k = gnn_trunk.unpack_blob(gnn_trunk.KernelParams(dblob, kp.F1), *args[1:6])
                p = gnn_trunk.gnn_trunk_backward_plain(*args, flat, src_T, adj_T, g)[0]
                parts = [gnn_trunk.gnn_trunk_backward_plain(
                    *args, flat, src_T[:, i:i + CHUNK], adj_T[:, i:i + CHUNK],
                    g[:, i:i + CHUNK], compute_dtype=torch.float64)[0]
                    for i in range(0, B, CHUNK)]
                x = [sum(pp[j] for pp in parts) for j in range(len(parts[0]))]
                bars = [1e-4 * pp.abs().max().item() + 1e-5 for pp in p]
                kx = [(kk.double() - xx).abs().max().item() / bb for kk, xx, bb in zip(k, x, bars)]
                px = [(pp.double() - xx).abs().max().item() / bb for pp, xx, bb in zip(p, x, bars)]
                kp_ = [(kk - pp).abs().max().item() / bb for kk, pp, bb in zip(k, p, bars)]
                conf = gnn_trunk.backward_config(E, Ds, args[2], kp.F1, args[3], args[4],
                                                 args[5], B)
                bufs = (torch.empty_like(src_T), torch.empty_like(adj_T),
                        torch.empty_like(kp.blob),
                        torch.empty((conf["ctas"], kp.blob.numel()), device=dev))
                ms = dev_ms(lambda: gnn_trunk.launch_backward_kernel(
                    *args, kp, src_T, adj_T, g, *bufs))
                print(json.dumps({"root": root, "relu": relu, "E": E, "Ds": Ds, "B": B,
                                  "seed": seed, "ms": ms,
                                  "repeat_bits": torch.equal(dblob, again),
                                  "worst_kernel_vs_plain_over_bar": max(kp_),
                                  "worst_kernel_vs_f64_over_bar": max(kx),
                                  "worst_plain_vs_f64_over_bar": max(px),
                                  "worst_leaf": kx.index(max(kx))}), flush=True)
                del parts, x, p, k, bufs
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
