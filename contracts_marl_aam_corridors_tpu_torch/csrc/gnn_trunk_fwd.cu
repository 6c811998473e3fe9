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
// What bounds it on this card: operations.  At the default widths (E = 6
// entities, Ds = 9, F1 = C = 16, H = 3, one embed layer, three conv layers)
// a rollout graph (24 unmasked edges) needs about 143K floating-point
// operations (ops/gnn_trunk.py trunk_work) against 744 bytes of inputs and
// output: some 190 operations a byte, far above the H100's 20 FP32
// operations a byte.  The q/k/v projections are about 60% of them.
//
// What the design does about it: it runs the panel code it shares with the
// backward kernel (csrc/gnn_trunk_panel.cuh, which describes the layout).
// - Graphs as the panel dimension.  A CTA owns NB consecutive graphs and
//   row m = e*NB + b entity e of graph b; the q/k/v projection is a product
//   with M = E*NB rows, warp-tiled m16n8k8 mma.sync in 3xTF32 on the tensor
//   cores (prod_qkv).  The skip Linear is each thread's own FP32 dot
//   products on the CUDA cores: in 3xTF32 the output lay up to 2.3x as far
//   from a float64 evaluation as the plain version's, over the forward bar
//   of 2x (PERF.md §2, §6), since the skip reaches the output directly
//   where q/k/v errors pass through the softmax's average.  The EmbedConv
//   edge chains, the masked softmax with its any-edge factor and the
//   weighted values are per-row loops over the graph's entities.
// - Its own shared-memory plan: the weights of one layer at a time (the
//   EmbedConv's, then each conv layer's, 11.6 KB at the defaults), staged
//   by cp.async so a thread's copies do not wait for one another, the
//   masked distances and the attention weights (one E x E plane each), two
//   x panels used in turn (layer l reads one and writes the other) and the
//   q/k/v scratch of one head; the backward's gradient planes and its n_tc
//   kept inputs are not needed.  About 2.3 KB a graph at E = 6.  Staging
//   the whole blob once per CTA instead was slower (PERF.md §6): its 37 KB
//   cost graphs an SM.
// - The launch plan (forward_plan): NB is whatever puts the most graphs on
//   an SM by shared memory, threads (at most 256 a CTA) and registers at the
//   launch bound (128 a thread, two CTAs of 256 threads an SM).  Where a
//   batch has fewer tiles than the card holds CTAs (the evaluation's 768
//   and 3,072 graphs), one tile's latency, not the card's throughput, sets
//   the time: the plan then spreads tiles of about B / SMs graphs, one CTA
//   an SM, and splits each row over the most threads S (8, 4 or 2; the
//   kernel's template parameter) that fit a CTA of 512, each with its
//   share of the channels and of the per-source loops.  No graph's result
//   depends on its tile, NB or S (every sum keeps the order of S = 1), so
//   all plans give the same bits.  The grid is persistent: all the CTAs
//   the card holds at once, or one a tile where there are fewer tiles.
//
// Interface: plain C functions, loaded with ctypes; the launch goes on the
// caller's stream, allocates nothing and returns cudaGetLastError() (or a
// negative code for a configuration it cannot run: embed and gnn widths
// other than 16, more than 32 entities, or more shared memory than a CTA
// may take).

#include "gnn_trunk_panel.cuh"

namespace {

// The launch bound: CTAs of at most 256 threads, two an SM, so at most 128
// registers a thread (16 warps an SM); a kernel that splits rows takes
// CTAs of up to 512 threads, one an SM, at the same 128 registers.
constexpr int kFwdThreads = 256;
constexpr int kFwdMinCtas = 2;
constexpr int kFwdRegs = kRegsPerSm / (kFwdThreads * kFwdMinCtas);
constexpr int kSplitThreads = 512;
// The largest split of a row over threads (a power of two dividing W).
constexpr int kMaxSplit = 8;

// The forward's shared-memory plan, in floats, beside the panel geometry.
struct FwdGeom : PanelGeom {
  int xa, xb;  // the two x panels
  __host__ __device__ FwdGeom(const Dims& d, const ParamLayout& pl, int nb, int split)
      : PanelGeom(d, nb, split) {
    int o = 0;
    w = o;
    o += round_up(imax(tc_floats(), pl.embed_size), 32);
    const int plane = round_up(d.E * LDA, 32);
    dm = o;
    o += plane;
    alpha = o;
    o += plane;
    xa = o;
    o += W * LD;
    xb = o;
    o += W * LD;
    // src and h_src (and with split > 1 the edge buffer) in the EmbedConv,
    // one head's q, k, v in a conv layer
    scr = o;
    int embed = hsrc + W * LD;
    if (split > 1) {
      // a slot stride of 32 / split (mod 32): a warp's split slots and
      // 32 / split rows fall on distinct banks
      es = round_up(W * LD, 32) + kWarp / split;
      ebuf = o + round_up(embed, 32);
      embed = round_up(embed, 32) + split * es;
    }
    o += imax(embed, 3 * W * LD);
    size = o;
  }
};

// The tile's adjacency from b0 into the dm plane as masked distances (0
// where 0 < d < max_edge_dist fails, and past the batch's end).
__device__ __forceinline__ void load_masked_distances(float* sm, const PanelGeom& G,
                                                      const Dims& d,
                                                      const float* __restrict__ adj_T,
                                                      long long B, long long b0,
                                                      float max_edge_dist) {
  for (int i = threadIdx.x; i < d.E * d.E * G.NB; i += blockDim.x) {
    const int r = i / G.NB, b = i - r * G.NB;  // r = s*E + t
    const int s = r / d.E, t = r - s * d.E;
    const long long gb = b0 + b;
    const float dv = gb < B ? adj_T[r * B + gb] : 0.f;
    sm[G.dm + s * G.LDA + t * G.NB + b] = (dv > 0.f && dv < max_edge_dist) ? dv : 0.f;
  }
}

// The CTA's loop over its tiles (tile i of the grid's CTA c is graphs
// (c + i * CTAs) * NB ...): the masked distances, src and h_src, the
// EmbedConv into panel xa, then the conv layers from one x panel into the
// other; the last layer's output goes from registers to `out`.  Thread tid
// is thread j = tid % S of row m = tid / S.
template <int S>
__global__ void __launch_bounds__(S == 1 ? kFwdThreads : kSplitThreads, S == 1 ? kFwdMinCtas : 1)
    gnn_trunk_fwd_panel_kernel(const float* __restrict__ src_T, const float* __restrict__ adj_T,
                               const float* __restrict__ params, float* __restrict__ out,
                               long long B, Dims d, float max_edge_dist, int embed_relu,
                               int gnn_relu, int nb) {
  extern __shared__ float sm[];
  const ParamLayout pl(d);
  const FwdGeom G(d, pl, nb, S);
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int m = tid / S, j = tid - m * S;
  const bool valid = m < G.M;
  const int e = valid ? m / nb : 0, b = valid ? m - e * nb : 0;
  // the lanes of this warp that own a row
  const unsigned rows = __ballot_sync(kFull, valid);
  float* w = sm + G.w;
  for (long long b0 = (long long)blockIdx.x * nb; b0 < B; b0 += (long long)gridDim.x * nb) {
    __syncthreads();
    for (int i = tid; i < pl.embed_size; i += blockDim.x) cp_async4(w + i, params + i);
    load_masked_distances(sm, G, d, adj_T, B, b0, max_edge_dist);
    cp_async_wait();
    load_src_hsrc<S>(sm, G, d, pl, src_T, B, b0, valid, m, j);
    embed_forward<S>(sm, G, d, pl, embed_relu, valid, m, b, sm + G.xa, j, rows);
    for (int l = 0; l < d.n_tc; ++l) {
      __syncthreads();
      stage_tc<true>(w, G, pl, params, l);
      cp_async_wait();
      __syncthreads();
      const float* X = sm + ((l & 1) ? G.xb : G.xa);
      float* Y = sm + ((l & 1) ? G.xa : G.xb);
      float acc[W / S];
      conv_forward<false, S>(sm, G, d, w, X, nullptr, valid, m, b, warp, lane, acc, j, rows);
      if (valid) {
        if (l + 1 < d.n_tc) {
#pragma unroll
          for (int i = 0; i < W / S; ++i) Y[chan<S>(j, i) * G.LD + m] = act(acc[i], gnn_relu);
        } else {
          const long long gb = b0 + b;
          if (gb < B) {
#pragma unroll
            for (int i = 0; i < W / S; ++i)
              out[(long long)(e * W + chan<S>(j, i)) * B + gb] = act(acc[i], gnn_relu);
          }
        }
      }
    }
  }
}

using FwdKernel = decltype(&gnn_trunk_fwd_panel_kernel<1>);

// The kernel of a plan's split.
FwdKernel fwd_kernel(int split) {
  return split == 8   ? gnn_trunk_fwd_panel_kernel<8>
         : split == 4 ? gnn_trunk_fwd_panel_kernel<4>
         : split == 2 ? gnn_trunk_fwd_panel_kernel<2>
                      : gnn_trunk_fwd_panel_kernel<1>;
}

// The plan of a launch over B graphs and its grid (see the note above).
int forward_plan(const Dims& d, int F1, int C, long long B, Plan* plan, int* grid) {
  int rc = check_dims(d, F1, C);
  if (rc != 0) return rc;
  if (B < 1) return -8;
  int dev = 0;
  DeviceInfo di;
  if ((rc = device_info(&dev, &di)) != 0) return rc;
  // no tile of more than kFwdThreads / (E * split) graphs fits a CTA
  if ((rc = best_plan<FwdGeom>(d, di, imax(kFwdThreads / d.E, 1), kFwdThreads, kFwdRegs, plan,
                               1)) != 0)
    return rc;
  if ((B + plan->nb - 1) / plan->nb < (long long)di.sms * plan->per_sm) {
    // fewer tiles than the card holds CTAs: tiles of about B / SMs graphs,
    // one CTA an SM, each row split over the most threads that fit a CTA
    const long long per_sm_graphs = (B + di.sms - 1) / di.sms;
    const ParamLayout pl(d);
    Plan p;
    for (int split = kMaxSplit; split > 1 && p.per_sm == 0; split /= 2)
      if (per_sm_graphs * d.E * split <= kSplitThreads)
        p = plan_for<FwdGeom>(d, pl, di, (int)per_sm_graphs, kSplitThreads, kFwdRegs, split);
    if (p.per_sm == 0) {
      const int nb = (int)(per_sm_graphs < plan->nb ? per_sm_graphs : plan->nb);
      p = plan_for<FwdGeom>(d, pl, di, nb, kFwdThreads, kFwdRegs, 1);
    }
    *plan = p;
  }
  if ((rc = allow_smem(fwd_kernel(plan->split), dev, plan->smem)) != 0) return rc;
  const long long tiles = (B + plan->nb - 1) / plan->nb;
  const long long ctas = (long long)di.sms * plan->per_sm;
  *grid = (int)(ctas < tiles ? ctas : tiles);
  return 0;
}

}  // namespace

// Graphs per CTA, threads a row, dynamic shared memory, parameter count,
// and the CTAs a launch over B graphs uses.
extern "C" int gnn_trunk_fwd_config(int E, int Ds, int H, int F1, int C, int n_embed, int n_tc,
                                    long long B, int* graphs_per_cta, int* threads_per_row,
                                    int* smem_bytes, int* n_params, int* grid) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  Plan plan;
  const int rc = forward_plan(d, F1, C, B, &plan, grid);
  if (rc != 0) return rc;
  *graphs_per_cta = plan.nb;
  *threads_per_row = plan.split;
  *smem_bytes = plan.smem;
  *n_params = ParamLayout(d).total;
  return 0;
}

// Threads a CTA, registers and local memory a thread, the CTAs an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the CTAs an SM the
// plan of a launch over B graphs counts (by shared memory, threads and
// registers), for the kernel that plan launches.
extern "C" int gnn_trunk_fwd_attributes(int E, int Ds, int H, int F1, int C, int n_embed,
                                        int n_tc, long long B, int* threads, int* regs,
                                        int* local_bytes, int* ctas_per_sm,
                                        int* planned_per_sm) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  Plan plan;
  int grid = 0;
  const int rc = forward_plan(d, F1, C, B, &plan, &grid);
  if (rc != 0) return rc;
  return kernel_attributes(fwd_kernel(plan.split), plan, threads, regs, local_bytes,
                           ctas_per_sm, planned_per_sm);
}

extern "C" int gnn_trunk_fwd(const float* src_T, const float* adj_T, const float* params,
                             float* out, long long B, int E, int Ds, int H, int F1, int C,
                             int n_embed, int n_tc, float max_edge_dist, int embed_relu,
                             int gnn_relu, int n_params, void* stream) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  Plan plan;
  int grid = 0;
  const int rc = forward_plan(d, F1, C, B, &plan, &grid);
  if (rc != 0) return rc;
  if (ParamLayout(d).total != n_params) return -5;
  fwd_kernel(plan.split)<<<grid, plan.threads, plan.smem, static_cast<cudaStream_t>(stream)>>>(
      src_T, adj_T, params, out, B, d, max_edge_dist, embed_relu, gnn_relu, plan.nb);
  return (int)cudaGetLastError();
}
