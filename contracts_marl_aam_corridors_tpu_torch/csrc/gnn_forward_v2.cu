// GNN trunk forward in the v2 formulation, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:72 make_gnn_forward_v2
// and takes its contract: the flat tuple of flatten_gnn_params_v2 (:226), in
// which each per-entity weight is expanded to a block-diagonal kron(I_E, W^T)
// matrix, each bias or LayerNorm vector is tiled E times, and the q/k/v
// projection is one (3*E*H*C, E*C) matrix `Wbig` whose rows are permuted
// (Q rows t*H*C + h*C + c; K rows E*H*C + h*E*C + s*C + c; V rows
// 2*E*H*C + h*E*C + s*C + c).  It computes what that kernel computes, the
// function of make_gnn_forward (EmbedConv, then 1 + gnn_layer_n
// TransformerConv layers with averaged heads), with the EmbedConv hidden width
// taken to be C, as v2 does.  The plain torch version is
// ops/gnn_trunk_v2.py gnn_forward_v2_plain.
//
// What bounds it on this card: FP32 arithmetic.  At E = 6 and the default
// depth a rollout graph needs about 143K operations for the function
// (ops/gnn_trunk.py trunk_work) and moves about 744 bytes of inputs and
// output, far above the H100's 20 FP32 operations per byte.  Written as the
// dense products of the TPU formulation it would need about 1.24M operations
// a graph (ops/gnn_trunk_v2.py v2_work): eight of nine multiply-adds of the
// block-diagonal products and all of those with the 0/1 selection matrices
// multiply zeros.
//
// What the design does about it: a CTA takes a tile of NB consecutive graphs,
// the batch being the N dimension of every product, and keeps each
// intermediate as a panel [row][graph] in shared memory, so neighbouring
// threads read neighbouring words.  Thread (e, g) owns entity block e of graph
// g.  Each stage is the product of one diagonal weight block with the
// thread's input block: lin1, the embed layers, the q/k/v projection (one
// head at a time) and lin_skip; the zero blocks of the block-diagonal
// matrices are skipped, so the kernel reads only the diagonal blocks of the
// v2 tuple, streamed from global memory through the caches (the tuple is
// 1.18 MB at E = 6, far more than a CTA's shared memory; a warp's lanes read
// the same weight words).  The group work that the TPU kernel does as
// products with five 0/1 matrices is done in registers: the per-16-feature
// LayerNorm is a thread's own 16 values, the per-source logit sums and the
// head sums are a thread's loops, and the any-edge factor is a maximum over
// the target's column of the edge mask.  Arithmetic is FP32 on the CUDA
// cores (no TF32, whose 10-bit mantissa misses the 1e-5 bar).  Masked logits
// take no part: a masked source's weight exp(finfo.min - max) is exactly zero,
// and a target with no in-edge, whose uniform softmax the any-edge factor
// zeroes, gets zero, so exp stays finite.
//
// Shared memory per graph, in floats: the masked distances (E*E), the node
// block x (E*C), and either the EmbedConv src and lin1 output (E*Ds + E*C)
// or one head's q, k, v (3*E*C) with its logits (E*E).  NB is the largest of
// 32, 16, 8, ... with E*NB <= 512 threads whose panels fit 227 KB: 32 graphs
// (58 KB) at E = 6, 32 (107 KB) at E = 10, 16 (133 KB) at E = 20.
//
// Interface: plain C functions, loaded with ctypes.  The launch takes the v2
// tuple as an array of device pointers, launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() (or a negative code for a
// configuration it cannot run).

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <mutex>

namespace {

constexpr int kWidth = 16;  // C, and the EmbedConv width, which v2 takes to be C
constexpr int kMaxEntities = 32;
constexpr int kMaxEmbedLayers = 4;
constexpr int kMaxTcLayers = 8;
constexpr int kMaxPtrs = 5 + 4 * kMaxEmbedLayers + 5 * kMaxTcLayers;
constexpr int kMaxThreads = 512;
constexpr int kSmemLimit = 232448;  // 227 KB a block can request on sm_90
constexpr float kLnEps = 1e-5f;

struct Dims {
  int E, Ds, H, n_embed, n_tc;
};

// The v2 tuple, in flatten_gnn_params_v2's order.
struct V2Params {
  const float* p[kMaxPtrs];
};

// Rows of each per-graph panel; a panel row holds NB graphs.
struct Layout {
  int dm, x, src, hsrc, qkv, lg, rows;
  __host__ __device__ Layout(const Dims& d, int C) {
    const int E = d.E;
    dm = 0;
    x = dm + E * E;
    src = x + E * C;  // EmbedConv only
    hsrc = src + E * d.Ds;
    qkv = x + E * C;  // TransformerConv only: q, k, v of one head
    lg = qkv + 3 * E * C;
    const int embed = hsrc + E * C, conv = lg + E * E;
    rows = embed > conv ? embed : conv;
  }
};

__device__ __forceinline__ float act(float v, int relu) {
  return relu ? fmaxf(v, 0.f) : tanhf(v);
}

template <int C>
__device__ __forceinline__ void layer_norm(float (&m)[C], const float* scale,
                                           const float* bias) {
  float mu = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) mu += m[c];
  mu = mu / C;
  float var = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float dv = m[c] - mu;
    var += dv * dv;
  }
  var = var / C;
  const float r = 1.f / sqrtf(var + kLnEps);
#pragma unroll
  for (int c = 0; c < C; ++c) m[c] = (m[c] - mu) * r * __ldg(scale + c) + __ldg(bias + c);
}

// y = W x + b for one C x C diagonal block: W points at the block's first
// row, `ld` floats apart, each row's C columns 16-byte aligned.
template <int C>
__device__ __forceinline__ void block_product(float (&y)[C], const float* W, int ld,
                                              const float (&x)[C], const float* b) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float4* row = reinterpret_cast<const float4*>(W + (long long)c * ld);
    float acc = 0.f;
#pragma unroll
    for (int k4 = 0; k4 < C / 4; ++k4) {
      const float4 w = __ldg(row + k4);
      acc = fmaf(w.x, x[4 * k4], acc);
      acc = fmaf(w.y, x[4 * k4 + 1], acc);
      acc = fmaf(w.z, x[4 * k4 + 2], acc);
      acc = fmaf(w.w, x[4 * k4 + 3], acc);
    }
    y[c] = acc + __ldg(b + c);
  }
}

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
    gnn_forward_v2_kernel(const float* __restrict__ src_T, const float* __restrict__ adj_T,
                          V2Params P, float* __restrict__ out, long long B, Dims d,
                          float max_edge_dist, int embed_relu, int gnn_relu, int NB) {
  extern __shared__ float smem[];
  const Layout L(d, C);
  const int E = d.E, Ds = d.Ds, H = d.H, EC = E * C, EHC = E * H * C;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int g = tid % NB, e = tid / NB;  // graph of the tile, entity block
  const long long b0 = (long long)blockIdx.x * NB;
#define PANEL(row) smem[(row) * NB + g]

  // the tile's masked distances (the edge mask is dm > 0) and src panels
  for (int i = tid; i < E * E * NB; i += nthreads) {
    const int r = i / NB, k = i % NB;
    const long long b = b0 + k;
    const float dv = b < B ? __ldg(adj_T + r * B + b) : 0.f;
    smem[(L.dm + r) * NB + k] = (dv > 0.f && dv < max_edge_dist) ? dv : 0.f;
  }
  for (int i = tid; i < E * Ds * NB; i += nthreads) {
    const int r = i / NB, k = i % NB;
    const long long b = b0 + k;
    smem[(L.src + r) * NB + k] = b < B ? __ldg(src_T + r * B + b) : 0.f;
  }
  __syncthreads();

  int p = 0;
  const float* W1 = P.p[p++];
  const float* b1 = P.p[p++];
  const float* we1 = P.p[p++];
  const float* ln1s = P.p[p++];
  const float* ln1b = P.p[p++];
  const int embed_p = p;
  p += 4 * d.n_embed;

  // lin1: h_src[e] = W1 block e . src[e] + b1[e]
  {
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    const float* W = W1 + (long long)e * C * (E * Ds) + e * Ds;
    for (int k = 0; k < Ds; ++k) {
      const float xk = PANEL(L.src + e * Ds + k);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = fmaf(__ldg(W + c * (E * Ds) + k), xk, acc[c]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) PANEL(L.hsrc + e * C + c) = acc[c] + __ldg(b1 + e * C + c);
  }
  __syncthreads();

  // EmbedConv, thread = target t = e: sum over masked sources s of the
  // message LN(act(h_src[s] + d(s->t) w_e1)) -> embed layers
  {
    const int t = e;
    float xs[C];
#pragma unroll
    for (int c = 0; c < C; ++c) xs[c] = 0.f;
    for (int s = 0; s < E; ++s) {
      const float dv = PANEL(L.dm + s * E + t);
      if (!(dv > 0.f)) continue;  // masked: adds 0 x message
      float m[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        m[c] = act(PANEL(L.hsrc + s * C + c) + dv * __ldg(we1 + s * C + c), embed_relu);
      layer_norm<C>(m, ln1s + s * C, ln1b + s * C);
      for (int l = 0; l < d.n_embed; ++l) {
        const float* Wl = P.p[embed_p + 4 * l];
        float nm[C];
        block_product<C>(nm, Wl + (long long)s * C * EC + s * C, EC, m,
                         P.p[embed_p + 4 * l + 1] + s * C);
#pragma unroll
        for (int c = 0; c < C; ++c) m[c] = act(nm[c], embed_relu);
        layer_norm<C>(m, P.p[embed_p + 4 * l + 2] + s * C, P.p[embed_p + 4 * l + 3] + s * C);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) xs[c] += m[c];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) PANEL(L.x + t * C + c) = xs[c];
  }
  __syncthreads();

  // TransformerConv stack
  const float inv_sqrt_c = 1.f / sqrtf((float)C);
  for (int l = 0; l < d.n_tc; ++l) {
    const float* Wbig = P.p[p];
    const float* bbig = P.p[p + 1];
    const float* wet = P.p[p + 2];
    const float* Wsk = P.p[p + 3];
    const float* bsk = P.p[p + 4];
    p += 5;
    float xe[C];  // this thread's node block, the layer's input
#pragma unroll
    for (int c = 0; c < C; ++c) xe[c] = PANEL(L.x + e * C + c);
    float osum[C];
#pragma unroll
    for (int c = 0; c < C; ++c) osum[c] = 0.f;

    for (int h = 0; h < H; ++h) {
      // q, k, v of entity e for head h: three diagonal blocks of Wbig
      {
        const int rows[3] = {e * H * C + h * C, EHC + h * EC + e * C, 2 * EHC + h * EC + e * C};
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float y[C];
          block_product<C>(y, Wbig + (long long)rows[j] * EC + e * C, EC, xe, bbig + rows[j]);
#pragma unroll
          for (int c = 0; c < C; ++c) PANEL(L.qkv + j * EC + e * C + c) = y[c];
        }
      }
      __syncthreads();

      // attention of target t = e over its masked sources
      {
        const int t = e;
        float any = 0.f;
        for (int s = 0; s < E; ++s) any = fmaxf(any, PANEL(L.dm + s * E + t) > 0.f ? 1.f : 0.f);
        if (any > 0.f) {
          float q[C];
#pragma unroll
          for (int c = 0; c < C; ++c) q[c] = PANEL(L.qkv + t * C + c);
          float mx = -FLT_MAX;
          for (int s = 0; s < E; ++s) {
            const float dv = PANEL(L.dm + s * E + t);
            if (!(dv > 0.f)) continue;
            const float4* we4 = reinterpret_cast<const float4*>(wet + h * EC + s * C);
            float acc = 0.f;
#pragma unroll
            for (int c4 = 0; c4 < C / 4; ++c4) {
              const float4 w = __ldg(we4 + c4);
              const float* kk = &PANEL(L.qkv + EC + s * C + 4 * c4);
              acc = fmaf(q[4 * c4], kk[0] + dv * w.x, acc);
              acc = fmaf(q[4 * c4 + 1], kk[NB] + dv * w.y, acc);
              acc = fmaf(q[4 * c4 + 2], kk[2 * NB] + dv * w.z, acc);
              acc = fmaf(q[4 * c4 + 3], kk[3 * NB] + dv * w.w, acc);
            }
            const float lv = acc * inv_sqrt_c;
            PANEL(L.lg + t * E + s) = lv;
            mx = fmaxf(mx, lv);
          }
          float sum = 0.f;
          for (int s = 0; s < E; ++s) {
            if (!(PANEL(L.dm + s * E + t) > 0.f)) continue;
            const float ex = expf(PANEL(L.lg + t * E + s) - mx);
            PANEL(L.lg + t * E + s) = ex;
            sum += ex;
          }
          float o[C];
#pragma unroll
          for (int c = 0; c < C; ++c) o[c] = 0.f;
          for (int s = 0; s < E; ++s) {
            const float dv = PANEL(L.dm + s * E + t);
            if (!(dv > 0.f)) continue;
            const float a = PANEL(L.lg + t * E + s) / sum;
            const float4* we4 = reinterpret_cast<const float4*>(wet + h * EC + s * C);
#pragma unroll
            for (int c4 = 0; c4 < C / 4; ++c4) {
              const float4 w = __ldg(we4 + c4);
              const float* vv = &PANEL(L.qkv + 2 * EC + s * C + 4 * c4);
              o[4 * c4] = fmaf(a, vv[0] + dv * w.x, o[4 * c4]);
              o[4 * c4 + 1] = fmaf(a, vv[NB] + dv * w.y, o[4 * c4 + 1]);
              o[4 * c4 + 2] = fmaf(a, vv[2 * NB] + dv * w.z, o[4 * c4 + 2]);
              o[4 * c4 + 3] = fmaf(a, vv[3 * NB] + dv * w.w, o[4 * c4 + 3]);
            }
          }
#pragma unroll
          for (int c = 0; c < C; ++c) osum[c] += o[c];
        }
      }
      __syncthreads();  // the next head overwrites q, k, v
    }

    // mean over heads + lin_skip (diagonal block t of Wskip) + act; only
    // this thread reads its own block of x from here on
    {
      const int t = e;
      float sk[C];
      block_product<C>(sk, Wsk + (long long)t * C * EC + t * C, EC, xe, bsk + t * C);
#pragma unroll
      for (int c = 0; c < C; ++c) PANEL(L.x + t * C + c) = act(osum[c] / (float)H + sk[c], gnn_relu);
    }
    __syncthreads();
  }

  const long long b = b0 + g;
  if (b < B) {
#pragma unroll
    for (int c = 0; c < C; ++c) out[(long long)(e * C + c) * B + b] = PANEL(L.x + e * C + c);
  }
#undef PANEL
}

// Graphs per CTA, threads and dynamic shared memory for these dimensions.
int configure(const Dims& d, int C, int* graphs_per_cta, int* threads, int* smem_bytes) {
  if (C != kWidth) return -1;
  if (d.E < 1 || d.E > kMaxEntities || d.Ds < 1 || d.H < 1) return -2;
  if (d.n_embed < 0 || d.n_embed > kMaxEmbedLayers || d.n_tc < 1 || d.n_tc > kMaxTcLayers)
    return -4;
  const int rows = Layout(d, C).rows;
  for (int nb = 32; nb >= 1; nb /= 2) {
    const long long smem = (long long)rows * nb * (long long)sizeof(float);
    if (d.E * nb <= kMaxThreads && smem <= kSmemLimit) {
      *graphs_per_cta = nb;
      *threads = d.E * nb;
      *smem_bytes = (int)smem;
      return 0;
    }
  }
  return -3;
}

// The dynamic shared memory size each device's kernel was opened up to.
constexpr int kMaxDevices = 64;
int g_smem_set[kMaxDevices];
std::mutex g_smem_mutex;

int allow_smem(int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return -6;
  std::lock_guard<std::mutex> lock(g_smem_mutex);
  if (g_smem_set[dev] >= smem) return 0;
  err = cudaFuncSetAttribute(gnn_forward_v2_kernel<kWidth>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return (int)err;
  g_smem_set[dev] = kSmemLimit;
  return 0;
}

}  // namespace

extern "C" int gnn_forward_v2_config(int E, int Ds, int H, int C, int n_embed, int n_tc,
                                     int* graphs_per_cta, int* threads, int* smem_bytes) {
  return configure(Dims{E, Ds, H, n_embed, n_tc}, C, graphs_per_cta, threads, smem_bytes);
}

extern "C" int gnn_forward_v2(const float* src_T, const float* adj_T, const void* const* params,
                              int n_params, float* out, long long B, int E, int Ds, int H,
                              int C, int n_embed, int n_tc, float max_edge_dist, int embed_relu,
                              int gnn_relu, void* stream) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  int NB = 0, threads = 0, smem = 0;
  const int rc = configure(d, C, &NB, &threads, &smem);
  if (rc != 0) return rc;
  if (n_params != 5 + 4 * n_embed + 5 * n_tc) return -5;
  if (B < 1) return -8;
  V2Params P{};
  for (int i = 0; i < n_params; ++i) P.p[i] = static_cast<const float*>(params[i]);
  const int arc = allow_smem(smem);
  if (arc != 0) return arc;
  const long long grid = (B + NB - 1) / NB;
  gnn_forward_v2_kernel<kWidth><<<(unsigned)grid, threads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      src_T, adj_T, P, out, B, d, max_edge_dist, embed_relu, gnn_relu, NB);
  return (int)cudaGetLastError();
}
