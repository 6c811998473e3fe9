"""How far the trunk forward kernel and the float32 plain version lie from
float64, over several draws of weights and graphs.

    python -m contracts_marl_aam_corridors_tpu_torch.tools.forward_f64 \
        [--graphs 2048] [--entities 20 6] [--weights 3] [--draws 4]

Needs the card (the kernel has no CPU version).  For tanh and relu, each of
``--weights`` GNN trunks (node features 8, drawn from seeds 2, 3, ...) and
each entity count, draws ``--draws`` batches of random graphs (distances up
to twice the edge range) and prints one JSON line with, per draw, the ratio
of the kernel's largest error to the plain version's and the ratio of
their relative L2 errors.  ``chip_smoke.py`` holds the forward kernels to
float64 by the first at E = 6 and by the second at E = 20, where the
largest error is one element's among hundreds of thousands.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..config.physics import vehicle_config
from ..envs.types import EnvParams
from ..models import ModelConfig, nets
from ..ops import gnn_trunk
from .relu_flips import _graphs


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--graphs", type=int, default=2048)
    ap.add_argument("--entities", type=int, nargs="+", default=[20, 6])
    ap.add_argument("--weights", type=int, default=3)
    ap.add_argument("--draws", type=int, default=4)
    a = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    max_edge = EnvParams(cfg=vehicle_config("air_taxi")).cfg.coordination_range
    out = []
    for act, relu in (("tanh", False), ("relu", True)):
        c = ModelConfig(max_edge_dist=max_edge, embed_use_relu=relu, gnn_use_relu=relu)
        for wseed in range(2, 2 + a.weights):
            gnn = nets.GNNBase(c, 8, "node")
            gnn.init_(torch.Generator().manual_seed(wseed))
            gnn = gnn.to(dev)
            flat = nets._flatten_gnn_params(gnn, c.embed_layer_n, c.gnn_layer_n)
            for E in a.entities:
                gen = torch.Generator().manual_seed(100 + E)
                max_ratio, l2_ratio = [], []
                for _ in range(a.draws):
                    node, adj, _ = _graphs(a.graphs, E, max_edge, gen, dev)
                    with torch.no_grad():
                        src_T = nets._gnn_src_T(gnn, node)
                        adj_T = adj.permute(1, 2, 0).reshape(E * E, -1).contiguous()
                        args = (E, src_T.shape[0] // E, c.gnn_num_heads, c.gnn_hidden_size,
                                c.embed_layer_n, c.gnn_layer_n, max_edge, (relu, relu))
                        k = gnn_trunk.gnn_trunk_forward(*args, gnn.kernel_params(), src_T, adj_T)
                        p = gnn_trunk.gnn_trunk_forward_plain(*args, flat, src_T, adj_T)
                        x = gnn_trunk.gnn_trunk_forward_plain(*args, flat, src_T, adj_T,
                                                              compute_dtype=torch.float64)
                    ek, ep = k.double() - x, p.double() - x
                    max_ratio.append(ek.abs().max().item() / ep.abs().max().item())
                    l2_ratio.append(ek.norm().item() / ep.norm().item())
                row = {"act": act, "weights_seed": wseed, "E": E, "graphs": a.graphs,
                       "max_err_ratio": max_ratio, "rel_l2_ratio": l2_ratio}
                print(json.dumps(row), flush=True)
                out.append(row)
    return out


if __name__ == "__main__":
    main()
