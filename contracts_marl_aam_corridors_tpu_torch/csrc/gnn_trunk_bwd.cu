// GNN trunk backward (EmbedConv + TransformerConv stack) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:594 make_gnn_bwd
// and computes what it computes: for a cotangent g of the trunk's (E*C, B)
// output, the vjp of xla_transposed_forward (gnn_pallas.py:487) with respect
// to the flat parameters (summed over the batch), the EmbedConv input src and
// the adjacency.  The plain torch version of this function is
// ops/gnn_trunk.py gnn_trunk_backward_plain (torch.autograd.grad of
// gnn_trunk_forward_plain); gnn_trunk_backward_layerwise_plain writes out
// this kernel's order of work in torch, for the CPU tests.
//
// What bounds it on this card: operations.  The function needs about three
// trunk forwards' operations a graph (ops/gnn_trunk.py trunk_bwd_work:
// 29.3 GFLOP for the update's 76,800 graphs, 0.437 ms at the FP32 peak of
// 67 TFLOP/s) against about 1.2 KB of inputs and outputs a graph.  This
// kernel does about four forwards' (it recomputes each conv layer once
// more).  The q/k/v projection is about 60% of a forward's operations
// (trunk_work: 85.5K of 143K a graph at E = 6 with 24 edges); it and the dX
// and dW products run on the tensor cores as 3xTF32 mma.sync (three TF32
// products for each FP32 one, about FP32's precision; TF32 alone misses the
// backward bar); the rest runs on the CUDA cores in FP32.
//
// What the design does about it (csrc/gnn_trunk_bwd.cuh):
// - Per-layer recompute.  The first forward keeps only the conv layers'
//   inputs x_0 .. x_{n_tc-1} (E*16 floats a graph each); each layer's
//   backward recomputes its q/k/v and attention weights head by head from
//   x_l.  The EmbedConv edge chains are recomputed in registers, stage by
//   stage.  Shared memory a graph (its panels and its share of the CTA's
//   scratch; the staged weights aside) at the default depth: 4.7 KB at
//   E = 6, 8.4 KB at E = 10, 19.9 KB at E = 20.
// - Graphs as the panel dimension.  A CTA owns NB consecutive graphs; thread
//   m = e*NB + b owns entity e of graph b, and each quantity is a panel of
//   feature rows over the M = E*NB columns.  The q/k/v projection (M x 16 by
//   16 x 48 a head), dX = dQKV W^T + dpre Wskip^T and dW = X^T dQKV,
//   dWskip = X^T dpre (K = M) are warp-tiled tensor-core products; the bias
//   and w_e gradients come out of the same loops as products with ones, so
//   the CTA's parameter gradient comes out of the products and no pass walks
//   the graphs.  The masked softmax and its backward, the any-edge factor,
//   the distance terms and the LayerNorms are each thread's own loops over
//   its graph's entities, 32 of 32 lanes busy; the EmbedConv's Linear
//   weight gradients are one tensor-core product over a warp's 32 edges,
//   its vector gradients a 16-shuffle warp sum.
// - Only the current layer's weights (10.9 KB at the defaults) are staged in
//   shared memory; the parameter gradients accumulate in the CTA's row of
//   the scratch buffer, each word always updated by the same thread.
// - NB is the count that puts the most graphs on an SM within 227 KB a CTA,
//   256 threads and, at the launch bound's 255 registers a thread, 8 warps
//   an SM (the plan assumes the bound, so it does not depend on the build,
//   and a launch never plans more CTAs than fit): 21 graphs (128
//   threads, 109,824 B, two CTAs an SM: 42 graphs, 8 warps) at E = 6, 25
//   (256 threads, 220,928 B, one CTA) at E = 10, 11 (224 threads, 231,040 B,
//   one CTA) at E = 20.  On the H100 the kernel takes 255 registers with
//   100 bytes of spills, so registers and shared memory both cap it at two
//   CTAs an SM at E = 6.
//
// Parameter gradients are summed without atomics, in a fixed order: each CTA
// adds every tile's into its row of a (CTAs, n_params) scratch buffer, and a
// second small kernel sums the rows in row order.  This takes the place of
// the TPU kernel's revisited output blocks on its sequential grid
// (gnn_pallas.py:628-632), and gives the same gradients from run to run.
// Every entity count up to 32 is taken; a batch is cut into tiles of NB
// graphs, the last one ragged.
//
// Interface: plain C functions, loaded with ctypes; they launch on the
// caller's stream, allocate nothing and return cudaGetLastError() (or a
// negative code for a configuration they cannot run).

#include "gnn_trunk_bwd.cuh"

namespace {

__global__ void __launch_bounds__(kMaxThreads)
    gnn_trunk_bwd_kernel(const float* __restrict__ src_T, const float* __restrict__ adj_T,
                         const float* __restrict__ g_T, const float* __restrict__ params,
                         float* __restrict__ dsrc_T, float* __restrict__ dadj_T, float* partial,
                         long long B, Dims d, float max_edge_dist, int embed_relu, int gnn_relu,
                         int nb) {
  Trunks<1> tr;
  tr.t[0] = {src_T, g_T, params, dsrc_T};
  backward_ctas<1>(tr, adj_T, dadj_T, partial, B, d, max_edge_dist, embed_relu, gnn_relu, nb);
}

}  // namespace

// Graphs per CTA, dynamic shared memory, parameter count, and the CTAs a
// launch over B graphs uses (the rows of the scratch buffer it needs).
extern "C" int gnn_trunk_bwd_config(int E, int Ds, int H, int F1, int C, int n_embed, int n_tc,
                                    long long B, int* graphs_per_cta, int* smem_bytes,
                                    int* n_params, int* grid) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  Plan plan;
  const int rc = grid_for(gnn_trunk_bwd_kernel, d, F1, C, B, &plan, grid);
  if (rc != 0) return rc;
  *graphs_per_cta = plan.nb;
  *smem_bytes = plan.smem;
  *n_params = ParamLayout(d).total;
  return 0;
}

// Threads a CTA, registers and local memory a thread, the CTAs an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the CTAs an SM the
// launch plans for (by shared memory, threads and registers).
extern "C" int gnn_trunk_bwd_attributes(int E, int Ds, int H, int F1, int C, int n_embed,
                                        int n_tc, int* threads, int* regs, int* local_bytes,
                                        int* ctas_per_sm, int* planned_per_sm) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  return kernel_attributes(gnn_trunk_bwd_kernel, d, F1, C, threads, regs, local_bytes,
                           ctas_per_sm, planned_per_sm);
}

extern "C" int gnn_trunk_bwd(const float* src_T, const float* adj_T, const float* g_T,
                             const float* params, float* dsrc_T, float* dadj_T, float* dparams,
                             float* partial, long long B, int E, int Ds, int H, int F1, int C,
                             int n_embed, int n_tc, float max_edge_dist, int embed_relu,
                             int gnn_relu, int n_params, int partial_rows, void* stream) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  if (B < 1) return -8;
  Plan plan;
  int grid = 0;
  const int rc = grid_for(gnn_trunk_bwd_kernel, d, F1, C, B, &plan, &grid);
  if (rc != 0) return rc;
  const int np = ParamLayout(d).total;
  if (np != n_params) return -5;
  if (grid > partial_rows) return -7;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  gnn_trunk_bwd_kernel<<<grid, plan.threads, plan.smem, st>>>(
      src_T, adj_T, g_T, params, dsrc_T, dadj_T, partial, B, d, max_edge_dist, embed_relu,
      gnn_relu, plan.nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_rows_kernel<<<(np + 255) / 256, 256, 0, st>>>(partial, dparams, grid, np);
  return (int)cudaGetLastError();
}
