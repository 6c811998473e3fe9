"""The trunk backward written out in the backward kernel's order of work
(``gnn_trunk_backward_layerwise_plain``) against autograd's vjp of the plain
trunk (``gnn_trunk_backward_plain``), on the CPU in float64.

The layerwise version is the CPU rehearsal of ``csrc/gnn_trunk_bwd.cuh``: a
forward that keeps only the conv layers' inputs, then per conv layer the
recomputed q/k/v and attention weights and the hand-written vjp (softmax
backward with the any-edge factor, the distance terms, the q/k/v products),
then the EmbedConv's per-edge LayerNorm and Linear backwards.  In float64
both are exact up to summation order, so every leaf is held at 1e-10 of its
largest entry.  Graph 0 has no edge at all and graph 1 no in-edge at target
0, so the any-edge factor and the masked softmax are both exercised.
"""
import numpy as np
import pytest
import torch

from contracts_marl_aam_corridors_tpu_torch.ops import gnn_trunk

torch.set_num_threads(1)

H, C, F1, DS = 3, 16, 16, 9
MAX_EDGE = 3.0
REL = 1e-10


def flat_params(rng, embed_layer_n, gnn_layer_n):
    """Random flat parameters (``flatten_gnn_params`` layout), float64."""
    w = lambda n_out, n_in: rng.randn(n_out, n_in) / np.sqrt(n_in)
    col = lambda n, base=0.0: base + 0.3 * rng.randn(n, 1)
    flat = [w(F1, DS), col(F1), col(F1), col(F1, 1.0), col(F1)]
    for _ in range(embed_layer_n):
        flat += [w(F1, F1), col(F1), col(F1, 1.0), col(F1)]
    cin = F1
    for _ in range(1 + gnn_layer_n):
        flat += [w(3 * H * C, cin), col(3 * H * C), col(H * C), w(C, cin), col(C)]
        cin = C
    return tuple(torch.tensor(p) for p in flat)


def inputs(rng, E, B):
    src_T = torch.tensor(rng.randn(E * DS, B))
    adj = rng.rand(B, E, E) * 2 * MAX_EDGE
    adj[:, np.arange(E), np.arange(E)] = 0.0
    adj[0] = 0.0  # no edge at all
    adj[1, :, 0] = 2 * MAX_EDGE  # target 0 has no in-edge
    adj_T = torch.tensor(np.ascontiguousarray(adj.transpose(1, 2, 0).reshape(E * E, B)))
    g = torch.tensor(rng.randn(E * C, B))
    return src_T, adj_T, g


@pytest.mark.parametrize("E,relu,embed_layer_n,gnn_layer_n,B", [
    (6, False, 1, 2, 24),
    (6, True, 1, 2, 24),
    (20, False, 1, 2, 6),
    (20, True, 1, 2, 6),
    (6, False, 0, 0, 16),
    (6, True, 2, 1, 16),
])
def test_layerwise_backward_matches_autograd(E, relu, embed_layer_n, gnn_layer_n, B):
    rng = np.random.RandomState(E + 7 * relu + 31 * embed_layer_n + gnn_layer_n)
    flat = flat_params(rng, embed_layer_n, gnn_layer_n)
    src_T, adj_T, g = inputs(rng, E, B)
    args = (E, DS, H, C, embed_layer_n, gnn_layer_n, MAX_EDGE, relu)
    got = gnn_trunk.gnn_trunk_backward_layerwise_plain(*args, flat, src_T, adj_T, g,
                                                       compute_dtype=torch.float64)
    want = gnn_trunk.gnn_trunk_backward_plain(*args, flat, src_T, adj_T, g,
                                              compute_dtype=torch.float64)
    got_leaves = list(got[0]) + [got[1], got[2]]
    want_leaves = list(want[0]) + [want[1], want[2]]
    assert len(got_leaves) == len(want_leaves)
    for i, (k, p) in enumerate(zip(got_leaves, want_leaves)):
        assert k.shape == p.shape and k.dtype == torch.float64, i
        assert p.abs().max() > 0, i
        err = (k - p).abs().max().item()
        assert err <= REL * p.abs().max().item(), (i, err, p.abs().max().item())
