// GNN trunk forward (EmbedConv + TransformerConv stack) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:299 make_gnn_forward
// and computes what it computes (the function of xla_transposed_forward,
// gnn_pallas.py:487): per graph, the edge mask 0 < d < max_edge_dist, the
// EmbedConv edge messages act(W1 src_s + b1 + d w_e) -> LN -> embed_layer_n x
// (Linear -> act -> LN) summed over masked sources, then 1 + gnn_layer_n
// TransformerConv layers (fused QKV, logits q.(k + d w_e)/sqrt(C) masked to
// -FLT_MAX, softmax over sources with zero weight for a node without
// in-edges, sum a v + (sum a d) w_e, mean over heads, skip Linear, act).
// The plain torch version is ops/gnn_trunk.py gnn_trunk_forward_plain.
//
// What bounds it on this card: FP32 arithmetic.  At the default widths
// (E = 6 entities, Ds = 9, F1 = C = 16, H = 3, one embed layer, three conv
// layers) a rollout graph (24 unmasked edges) needs about 143K floating-point
// operations (ops/gnn_trunk.py trunk_work) and moves 744 bytes (inputs read
// once, output written once): some 190 operations per byte, far above the
// H100's 67 TFLOP/s / 3.35 TB/s = 20 FP32 operations per byte.  The products
// are 16 wide per graph and FP32, so no tensor core takes them here; the
// bound is the FP32 pipe.
//
// What the design does about it: each graph is one warp's job, and all of a
// graph's intermediates (masks, messages, QKV, logits) stay in shared memory
// and registers; nothing but the inputs and the (E*C) output touches device
// memory.  The ~35 KB of flattened parameters are staged once per CTA in
// shared memory, stored (in, out) so the lanes of a warp read consecutive
// words or one broadcast word.  A CTA of G warps takes G consecutive graphs
// at a time, so the loads of the batch-minor inputs and the store of the
// output move whole 32-byte sectors; a grid-stride loop over graph tiles
// takes any batch size without padding.  Edge messages are computed one edge
// per lane in registers (LayerNorm over a lane's own 16 values needs no
// shuffles) and summed over sources in source order, as the plain version
// does.  Masked logits use -FLT_MAX, not -INFINITY, so a fully masked row
// gives a uniform softmax that the any-edge factor zeroes instead of NaN.
//
// The kernel, its configuration and its launch live in gnn_trunk_fwd.cuh as
// templates over the number of trunks that share one adjacency; this file
// instantiates them for one trunk.
//
// Interface: a plain C function, loaded with ctypes; it launches on the
// caller's stream, allocates nothing and returns cudaGetLastError() (or a
// negative code for a configuration it cannot run: embed and gnn widths other
// than 16, more than 32 entities, or more shared memory than a CTA may take).

#include "gnn_trunk_fwd.cuh"

extern "C" int gnn_trunk_fwd_config(int E, int Ds, int H, int F1, int C, int n_embed,
                                    int n_tc, int* graphs_per_cta, int* smem_bytes,
                                    int* n_params) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  return configure<1>(d, F1, C, graphs_per_cta, smem_bytes, n_params);
}

extern "C" int gnn_trunk_fwd(const float* src_T, const float* adj_T, const float* params,
                             float* out, long long B, int E, int Ds, int H, int F1, int C,
                             int n_embed, int n_tc, float max_edge_dist, int embed_relu,
                             int gnn_relu, int n_params, void* stream) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  const TrunkPtrs<1> t{{src_T}, {params}, {out}};
  return launch_forward<1>(t, adj_T, B, d, F1, C, max_edge_dist, embed_relu, gnn_relu,
                           n_params, stream);
}
