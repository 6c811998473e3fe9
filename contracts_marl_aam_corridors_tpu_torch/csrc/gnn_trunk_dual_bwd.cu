// Both GNN trunks (the actor's and the critic's) backward in one launch, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:712 make_gnn_fused_dual
//   (bwd_kernel, pallas_call at :768)
// and computes what it computes: for the cotangents ga and gc of the two
// (E*C, B) outputs, the vjp of the pair function f_pair (gnn_pallas.py:694)
// with respect to both parameter sets (summed over the batch), both EmbedConv
// inputs and the shared adjacency, whose gradient is the sum of the two
// trunks'.  The plain torch version is ops/gnn_trunk.py
// gnn_trunk_dual_backward_plain (torch.autograd.grad of the plain pair).
//
// What bounds it on this card: FP32 arithmetic, as for the single backward
// (about three trunk forwards' operations per trunk, ops/gnn_trunk.py
// dual_bwd_work, against about 2.2 KB of inputs and outputs per graph).
//
// What the design does about it: the single backward's per-graph work
// (csrc/gnn_trunk_bwd.cuh: one warp per graph recomputes the forward into
// shared memory, keeps the residuals there and runs the vjp in reverse layer
// order) is done for each trunk in turn.  Both trunks' residuals at once would
// not fit a CTA at E = 20 (about 88 KB a graph per trunk) and would halve the
// graphs per CTA at E = 6, so per tile of graphs the CTA reads the adjacency
// once, keeps the edge mask and masked distances for both trunks, and runs
// the actor's recompute and vjp and then the critic's on one residual buffer.
// The distance gradient accumulates in that buffer across both, actor first.
//
// Parameter gradients are summed without atomics, in a fixed order, as in the
// single backward, into a per-CTA row now 2 x n_params wide (actor, then
// critic): the row lives in the scratch buffer in device memory rather than
// in shared memory, each word read and written by the one thread that owns
// it, which leaves shared memory for as many graphs per CTA as the single
// backward takes.  A second small kernel sums the rows in row order, so the
// gradients are the same from run to run.
//
// Interface: plain C functions, loaded with ctypes; they launch on the
// caller's stream, allocate nothing and return cudaGetLastError() (or a
// negative code for a configuration they cannot run).

#include "gnn_trunk_bwd.cuh"

namespace {

__global__ void __launch_bounds__(kWarp* kMaxGraphsPerCta)
    gnn_trunk_dual_bwd_kernel(const float* __restrict__ src_a_T,
                              const float* __restrict__ src_c_T,
                              const float* __restrict__ adj_T, const float* __restrict__ g_a_T,
                              const float* __restrict__ g_c_T,
                              const float* __restrict__ params_a,
                              const float* __restrict__ params_c,
                              float* __restrict__ dsrc_a_T, float* __restrict__ dsrc_c_T,
                              float* __restrict__ dadj_T, float* partial, long long B, Dims d,
                              float max_edge_dist, int embed_relu, int gnn_relu, int G) {
  extern __shared__ float smem[];
  const ParamLayout pl(d);
  const Layout L(d, pl);
  const int np = pl.total, npad = (np + 31) & ~31;
  float* P_a = smem;
  float* P_c = smem + npad;
  float* tiles = smem + 2 * npad;
  float* acc_a = partial + (long long)blockIdx.x * 2 * np;
  float* acc_c = acc_a + np;
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    P_a[i] = params_a[i];
    P_c[i] = params_c[i];
    acc_a[i] = 0.f;
    acc_c[i] = 0.f;
  }
  __syncthreads();

  for (long long b0 = (long long)blockIdx.x * G; b0 < B; b0 += (long long)gridDim.x * G) {
    const int n = (int)(B - b0 < G ? B - b0 : G);
    load_adjacency(tiles, adj_T, B, b0, G, L, d, max_edge_dist);
    trunk_tile_backward(tiles, src_a_T, g_a_T, P_a, acc_a, dsrc_a_T, B, b0, n, G, pl, L, d,
                        embed_relu, gnn_relu);
    trunk_tile_backward(tiles, src_c_T, g_c_T, P_c, acc_c, dsrc_c_T, B, b0, n, G, pl, L, d,
                        embed_relu, gnn_relu);
    store_dadj(tiles, dadj_T, B, b0, G, L, d);
    __syncthreads();
  }
}

}  // namespace

// Graphs per CTA, dynamic shared memory, parameter count of one trunk, and
// the CTAs a launch over B graphs uses (the rows of the (CTAs, 2 n_params)
// scratch buffer it needs).
extern "C" int gnn_trunk_dual_bwd_config(int E, int Ds, int H, int F1, int C, int n_embed,
                                         int n_tc, long long B, int* graphs_per_cta,
                                         int* smem_bytes, int* n_params, int* grid) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  return grid_for(gnn_trunk_dual_bwd_kernel, d, F1, C, B, graphs_per_cta, smem_bytes, n_params,
                  grid);
}

// dparams gets 2 n_params floats: the actor's gradient, then the critic's.
extern "C" int gnn_trunk_dual_bwd(const float* src_a_T, const float* src_c_T, const float* adj_T,
                                  const float* g_a_T, const float* g_c_T, const float* params_a,
                                  const float* params_c, float* dsrc_a_T, float* dsrc_c_T,
                                  float* dadj_T, float* dparams, float* partial, long long B,
                                  int E, int Ds, int H, int F1, int C, int n_embed, int n_tc,
                                  float max_edge_dist, int embed_relu, int gnn_relu,
                                  int n_params, int partial_rows, void* stream) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  if (B < 1) return -8;
  int G = 0, smem = 0, np = 0, grid = 0;
  const int rc = grid_for(gnn_trunk_dual_bwd_kernel, d, F1, C, B, &G, &smem, &np, &grid);
  if (rc != 0) return rc;
  if (np != n_params) return -5;
  if (grid > partial_rows) return -7;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  gnn_trunk_dual_bwd_kernel<<<grid, kWarp * G, smem, st>>>(
      src_a_T, src_c_T, adj_T, g_a_T, g_c_T, params_a, params_c, dsrc_a_T, dsrc_c_T, dadj_T,
      partial, B, d, max_edge_dist, embed_relu, gnn_relu, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_rows_kernel<<<(2 * np + 255) / 256, 256, 0, st>>>(partial, dparams, grid, 2 * np);
  return (int)cudaGetLastError();
}
