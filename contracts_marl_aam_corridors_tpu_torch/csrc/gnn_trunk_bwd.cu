// GNN trunk backward (EmbedConv + TransformerConv stack) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:594 make_gnn_bwd
// and computes what it computes: for a cotangent g of the trunk's (E*C, B)
// output, the vjp of xla_transposed_forward (gnn_pallas.py:487) with respect
// to the flat parameters (summed over the batch), the EmbedConv input src and
// the adjacency.  The forward is the one of csrc/gnn_trunk_fwd.cu; the plain
// torch version of this function is ops/gnn_trunk.py gnn_trunk_backward_plain
// (torch.autograd.grad of gnn_trunk_forward_plain).
//
// What bounds it on this card: FP32 arithmetic.  At the default widths a
// graph of the PPO update needs about 3x the forward's operations (the
// recomputed forward and its vjp; ops/gnn_trunk.py trunk_bwd_work) against
// about 1.2 KB of inputs and outputs, far above the H100's 20 FP32
// operations per byte; the products are 16 wide per graph, too small for
// the tensor cores.
//
// What the design does about it: as in the forward, each graph is one
// warp's job.  The warp recomputes the forward into the graph's own shared
// memory and keeps every residual the vjp needs there (layer inputs, QKV,
// attention weights); nothing but the inputs and the outputs touches device
// memory.  The backward runs in reverse layer order.  EmbedConv edge chains
// are recomputed per lane in registers (one edge per lane, as the forward
// computes them), stage by stage from the edge's input, so no per-edge
// residual is stored.  Attention gradients are computed by the lane that
// owns each (target, head), key and value gradients by the lane that owns
// each (source, column), so no two lanes write one word.
//
// Parameter gradients are summed without atomics, in a fixed order: after
// each conv layer's backward (and after the EmbedConv's) the CTA's threads
// each own some parameter words and add that layer's sum over the CTA's
// graphs to a per-CTA accumulator in shared memory.  Each CTA writes its
// accumulator as one row of a (CTAs, n_params) scratch buffer, and a second
// small kernel sums the rows in row order.  This takes the place of the TPU
// kernel's revisited output blocks on its sequential grid (gnn_pallas.py:
// 628-632), and gives the same gradients from run to run.
//
// Masked logits are -FLT_MAX as in the forward; a target with no in-edge has
// zero attention weights, so its attention gradients are exactly zero.
// Every entity count up to 32 is taken (E = 20 included): the graphs per CTA
// shrink with the per-graph shared memory, down to one.
//
// Interface: plain C functions, loaded with ctypes; they launch on the
// caller's stream, allocate nothing and return cudaGetLastError() (or a
// negative code for a configuration they cannot run).

#include "gnn_trunk_bwd.cuh"

namespace {

__global__ void __launch_bounds__(kWarp* kMaxGraphsPerCta)
    gnn_trunk_bwd_kernel(const float* __restrict__ src_T, const float* __restrict__ adj_T,
                         const float* __restrict__ g_T, const float* __restrict__ params,
                         float* __restrict__ dsrc_T, float* __restrict__ dadj_T,
                         float* __restrict__ partial, long long B, Dims d, float max_edge_dist,
                         int embed_relu, int gnn_relu, int G) {
  extern __shared__ float smem[];
  const ParamLayout pl(d);
  const Layout L(d, pl);
  const int np = pl.total, npad = (np + 31) & ~31;
  float* P = smem;
  float* acc = smem + npad;
  float* tiles = acc + npad;
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    P[i] = params[i];
    acc[i] = 0.f;
  }
  __syncthreads();

  for (long long b0 = (long long)blockIdx.x * G; b0 < B; b0 += (long long)gridDim.x * G) {
    const int n = (int)(B - b0 < G ? B - b0 : G);
    load_adjacency(tiles, adj_T, B, b0, G, L, d, max_edge_dist);
    trunk_tile_backward(tiles, src_T, g_T, P, acc, dsrc_T, B, b0, n, G, pl, L, d, embed_relu,
                        gnn_relu);
    store_dadj(tiles, dadj_T, B, b0, G, L, d);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < np; i += blockDim.x) partial[(long long)blockIdx.x * np + i] = acc[i];
}

}  // namespace

// Graphs per CTA, dynamic shared memory, parameter count, and the CTAs a
// launch over B graphs uses (the rows of the scratch buffer it needs).
extern "C" int gnn_trunk_bwd_config(int E, int Ds, int H, int F1, int C, int n_embed, int n_tc,
                                    long long B, int* graphs_per_cta, int* smem_bytes,
                                    int* n_params, int* grid) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  return grid_for(gnn_trunk_bwd_kernel, d, F1, C, B, graphs_per_cta, smem_bytes, n_params,
                  grid);
}

extern "C" int gnn_trunk_bwd(const float* src_T, const float* adj_T, const float* g_T,
                             const float* params, float* dsrc_T, float* dadj_T, float* dparams,
                             float* partial, long long B, int E, int Ds, int H, int F1, int C,
                             int n_embed, int n_tc, float max_edge_dist, int embed_relu,
                             int gnn_relu, int n_params, int partial_rows, void* stream) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  if (B < 1) return -8;
  int G = 0, smem = 0, np = 0, grid = 0;
  const int rc = grid_for(gnn_trunk_bwd_kernel, d, F1, C, B, &G, &smem, &np, &grid);
  if (rc != 0) return rc;
  if (np != n_params) return -5;
  if (grid > partial_rows) return -7;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  gnn_trunk_bwd_kernel<<<grid, kWarp * G, smem, st>>>(src_T, adj_T, g_T, params, dsrc_T, dadj_T,
                                                      partial, B, d, max_edge_dist, embed_relu,
                                                      gnn_relu, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_rows_kernel<<<(np + 255) / 256, 256, 0, st>>>(partial, dparams, grid, np);
  return (int)cudaGetLastError();
}
