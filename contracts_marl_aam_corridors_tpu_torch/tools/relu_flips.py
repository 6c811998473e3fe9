"""How far the float32 plain trunk backward lies from float64, graph by
graph, with relu activations, and which relu units flip between the two.

    python -m contracts_marl_aam_corridors_tpu_torch.tools.relu_flips \
        [--graphs 76800] [--chunk 9600] [--seed 1] [--device cpu]

Takes the default actor's GNN trunk (``GRMAPPOPolicy.init_params(0)`` of the
july air_taxi model, relu), draws random graphs (E = 6, distances up to
twice the edge range) from ``--seed`` in chunks, and runs
``gnn_trunk_backward_plain`` in float32 and in float64 on each chunk.
Prints one JSON line: the relative L2 distance of dsrc and dadj over all
graphs and over the graphs that agree, the graphs whose dsrc lies further
than 1e-3 of its largest entry from float64, and, for the worst of them,
every relu input whose sign differs between the two precisions, and how
many graphs ``near_zero_graphs`` sets aside (``chip_smoke.py`` holds the
backward kernels on the other graphs).
"""
from __future__ import annotations

import argparse
import json

import torch

from ..config.physics import vehicle_config
from ..device import resolve_device
from ..envs.types import EnvParams
from ..models import GRMAPPOPolicy, ModelConfig, PolicyDims, nets
from ..ops import gnn_trunk

OFF = 1e-3  # a graph is off where its dsrc error exceeds this share of its largest entry
# a relu input within this many times its call's float32 error of zero may flip
ROUNDING_MARGIN = 16.0


def _graphs(n, E, max_edge, gen, dev):
    node = torch.randn((n, E, 8), generator=gen).to(dev)
    node[..., -1] = torch.randint(0, 2, (n, E), generator=gen).float().to(dev)
    a = torch.rand((n, E, E), generator=gen).to(dev) * 2 * max_edge
    adj = (a + a.transpose(1, 2)) / 2
    adj[:, torch.arange(E), torch.arange(E)] = 0.0
    g = torch.randn((E * 16, n), generator=gen).to(dev)
    return node, adj, g


def _relu_inputs(args, flat, src_T, adj_T, dtype):
    """Every relu input of one plain forward, in call order."""
    seen = []

    def act(relu):
        if not relu:
            return torch.tanh
        return lambda x: (seen.append(x.detach()), torch.relu(x))[1]

    plain_act, gnn_trunk._act = gnn_trunk._act, act
    try:
        gnn_trunk.gnn_trunk_forward_plain(*args, flat, src_T, adj_T, compute_dtype=dtype)
    finally:
        gnn_trunk._act = plain_act
    return seen


def near_zero_graphs(args, flat, src_T, adj_T, margin: float = ROUNDING_MARGIN):
    """(B,) bool: the graphs in which some relu input of the plain forward
    lies within float32 rounding of zero, in float32 or in float64, so that
    another float32 order of the same sums (the kernel's) may give it the
    other sign and its subgradient.  The float32 rounding of a relu input is
    taken as ``margin`` times the distance between its float32 and float64
    values; an input that is exactly zero in both (an edgeless graph's,
    with zero biases) is zero in every order."""
    B = src_T.shape[-1]
    near = torch.zeros(B, dtype=torch.bool, device=src_T.device)
    pre32 = _relu_inputs(args, flat, src_T, adj_T, torch.float32)
    pre64 = _relu_inputs(args, flat, src_T, adj_T, torch.float64)
    for x32, x64 in zip(pre32, pre64):
        x32, x64 = x32.double().reshape(-1, B), x64.reshape(-1, B)
        rounding = margin * (x32 - x64).abs()
        near |= (torch.minimum(x32.abs(), x64.abs()) < rounding).any(0)
    return near


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--graphs", type=int, default=76_800)
    ap.add_argument("--chunk", type=int, default=9_600)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    ep = EnvParams(cfg=vehicle_config("air_taxi"))
    cfg = ModelConfig(max_edge_dist=ep.cfg.coordination_range)
    dims = PolicyDims(ep.obs_dim, ep.obs_dim * ep.num_agents, ep.num_entities,
                      ep.node_feat_dim, ep.num_actions)
    gnn = GRMAPPOPolicy(cfg, dims, device=dev).init_params(0).actor.gnn_base
    E = ep.num_entities
    flat = nets._flatten_gnn_params(gnn, cfg.embed_layer_n, cfg.gnn_layer_n)
    gen = torch.Generator().manual_seed(a.seed)
    sums = {k: [0.0, 0.0, 0.0, 0.0] for k in ("dsrc", "dadj")}  # err2, ref2, err2 kept, ref2 kept
    off, worst, near = [], None, 0
    for c0 in range(0, a.graphs, a.chunk):
        n = min(a.chunk, a.graphs - c0)
        node, adj, g = _graphs(n, E, cfg.max_edge_dist, gen, dev)
        with torch.no_grad():
            src_T = nets._gnn_src_T(gnn, node)
        adj_T = adj.permute(1, 2, 0).reshape(E * E, n).contiguous()
        args = (E, src_T.shape[0] // E, cfg.gnn_num_heads, cfg.gnn_hidden_size,
                cfg.embed_layer_n, cfg.gnn_layer_n, cfg.max_edge_dist,
                (cfg.embed_use_relu, cfg.gnn_use_relu))
        _, ds32, da32 = gnn_trunk.gnn_trunk_backward_plain(*args, flat, src_T, adj_T, g)
        _, ds64, da64 = gnn_trunk.gnn_trunk_backward_plain(*args, flat, src_T, adj_T, g,
                                                          compute_dtype=torch.float64)
        near += int(near_zero_graphs(args, flat, src_T, adj_T).sum().item())
        err = (ds32.double() - ds64).abs().amax(0)
        size = ds64.abs().amax(0)
        bad = err > OFF * size
        for i in bad.nonzero().flatten().tolist():
            off.append({"graph": c0 + i, "dsrc_max_err": err[i].item(),
                        "dsrc_max": size[i].item()})
            if worst is None or err[i] > worst[0]:
                worst = (err[i].item(), args, src_T[:, i:i + 1], adj_T[:, i:i + 1])
        for k, x32, x64 in (("dsrc", ds32, ds64), ("dadj", da32, da64)):
            e2 = (x32.double() - x64).pow(2).sum(0)
            r2 = x64.pow(2).sum(0)
            s = sums[k]
            s[0] += e2.sum().item()
            s[1] += r2.sum().item()
            s[2] += e2[~bad].sum().item()
            s[3] += r2[~bad].sum().item()
    flips = []
    if worst is not None:
        _, args, src1, adj1 = worst
        pre32 = _relu_inputs(args, flat, src1, adj1, torch.float32)
        pre64 = _relu_inputs(args, flat, src1, adj1, torch.float64)
        for call, (x32, x64) in enumerate(zip(pre32, pre64)):
            flip = (x32 > 0) != (x64 > 0)
            flips += [{"relu_call": call, "float32": u, "float64": v}
                      for u, v in zip(x32[flip].tolist(), x64[flip].tolist())]
    out = {"graphs": a.graphs, "device": str(dev),
           "rel_l2": {k: (s[0] / s[1]) ** 0.5 for k, s in sums.items()},
           "rel_l2_without_off_graphs": {k: (s[2] / s[3]) ** 0.5 for k, s in sums.items()},
           "graphs_off": off, "graphs_near_zero_relu_input": near,
           "worst_graph_relu_flips": flips}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
