// Device code of the GNN trunk backward, shared by csrc/gnn_trunk_bwd.cu (one
// trunk per launch) and csrc/gnn_trunk_dual_bwd.cu (the actor and critic
// trunks in one launch): the parameter layout, the tile geometry and
// shared-memory plan, the 3xTF32 tensor-core products over a tile's panels,
// the per-thread attention, softmax, LayerNorm and distance steps, one
// trunk's backward over a tile of graphs, the CTA loop over tiles, the
// in-order row sum and the launch configuration.
//
// A tile is NB consecutive graphs.  Every per-graph quantity lives in a
// panel: feature row k holds that feature for all M = E*NB (entity, graph)
// pairs of the tile, m = e*NB + b, so a panel is a column-major (M x rows)
// matrix with leading dimension LD, and thread m owns column m.  The three
// product families of a conv layer are then products with M or K = M:
// q/k/v = X W_h (M x 16 by 16 x 48 per head), dX = dQKV_h W_h^T + dpre
// Wskip^T, and dW_h = X^T dQKV_h, dWskip = X^T dpre with K = M, whose bias
// and w_e gradients come out of the same products as column sums (a product
// with a matrix of ones).  The E x E per-graph arrays (masked distances,
// distance gradient, attention weights and their gradients) are planes
// [s][t*NB + b], one plane per source s.
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// The one width instantiated (embed hidden = gnn hidden = 16), as in the
// forward kernel.
constexpr int W = 16;
constexpr int kMaxEntities = 32;
constexpr int kMaxEmbedLayers = 4;
constexpr int kMaxTcLayers = 8;
constexpr int kMaxGraphsPerCta = 32;
// At most 256 threads a CTA, so a thread may keep up to 255 registers.
constexpr int kMaxThreads = 256;
constexpr int kSmemLimit = 232448;  // 227 KB a block can request on sm_90
constexpr int kMaxThreadsPerSm = 2048;
constexpr int kMaxCtasPerSm = 32;
// The register file of an SM and what a warp takes of it at the launch
// bound's 255 registers a thread (allocated 8 a thread at a time): 8 warps
// an SM, whatever the compiler makes of the kernel.
constexpr int kRegsPerSm = 65536;
constexpr int kRegsPerWarp = 256 * kWarp;
constexpr float kNeg = -FLT_MAX;  // finfo(float32).min
constexpr float kLnEps = 1e-5f;
// Row stride of a warp's staging rows (32 lanes + 4): the tensor-core
// fragments of a (16 x 32) block then read 32 distinct banks.
constexpr int kStage = kWarp + 4;

struct Dims {
  int E, Ds, H, n_embed, n_tc;
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Offsets into the parameter blob (ops/gnn_trunk.py param_blob order):
// W1 (Ds, W), b1, w_e1, ln1 scale, ln1 bias, n_embed x [W (W, W), b, ln
// scale, ln bias], n_tc x [Wqkv (W, 3HW), bqkv, w_e (HW), Wskip (W, W),
// bskip]; weights stored (in, out).
struct ParamLayout {
  int b1, we1, ln1s, ln1b, embed0, embed_stride, embed_size, tc0, tc_stride, total;
  __host__ __device__ explicit ParamLayout(const Dims& d) {
    const int QKV = 3 * d.H * W;
    b1 = d.Ds * W;
    we1 = b1 + W;
    ln1s = we1 + W;
    ln1b = ln1s + W;
    embed0 = ln1b + W;
    embed_stride = W * W + 3 * W;
    embed_size = embed0 + d.n_embed * embed_stride;
    tc0 = embed_size;
    tc_stride = W * QKV + QKV + d.H * W + W * W + W;
    total = tc0 + d.n_tc * tc_stride;
  }
  // LayerNorm scale / bias of EmbedConv stage l (0: ln1, l >= 1: ln{l+1})
  __device__ int ln_scale(int l) const {
    return l == 0 ? ln1s : embed0 + (l - 1) * embed_stride + W * W + W;
  }
  __device__ int ln_bias(int l) const {
    return l == 0 ? ln1b : embed0 + (l - 1) * embed_stride + W * W + 2 * W;
  }
};

// The tile geometry and the CTA's shared memory plan, in floats.
struct Geom {
  int NB, M, Mp, T, nw, LD, LDA, HC, QKV, ldw;
  // the staged conv layer's weights, from `w`: Wqkv (W rows of ldw), bqkv,
  // w_e, Wskip (W x W), bskip; the EmbedConv's are staged at their blob
  // offsets
  int wq, bq, we, wsk, bsk;
  int w, dm, dadj, alpha, us, xs, dpre, dx, scr, size;
  // inside scr during the EmbedConv phases: src (Ds rows), h_src (W rows),
  // each warp's staging rows and its parameter-gradient accumulator
  int hsrc, stage, wacc, wacc_stride;
  __host__ __device__ Geom(const Dims& d, const ParamLayout& pl, int nb) {
    NB = nb;
    M = d.E * nb;
    Mp = round_up(M, 16);
    T = round_up(M, kWarp);
    nw = T / kWarp;
    // LD = 8 (mod 32): a fragment's rows (stride 1) and columns (stride LD)
    // fall on distinct banks
    LD = Mp + (40 - Mp % 32) % 32;
    // a plane's stride = NB (mod 32): where a warp spans several sources,
    // their rows of one target fall on distinct banks
    LDA = M + (NB % 32 - M % 32 + 32) % 32;
    HC = d.H * W;
    QKV = 3 * HC;
    ldw = QKV + 8;  // = 8 or 24 (mod 32)
    wq = 0;
    bq = W * ldw;
    we = bq + QKV;
    wsk = we + HC;
    bsk = wsk + W * W;
    int o = 0;
    w = o;
    o += round_up(imax(bsk + W, pl.embed_size), 32);
    const int plane = round_up(d.E * LDA, 32);
    dm = o;
    o += plane;
    dadj = o;
    o += plane;
    alpha = o;
    o += plane;
    us = o;
    o += plane;
    xs = o;  // the conv layers' inputs x_0 .. x_{n_tc - 1}
    o += d.n_tc * W * LD;
    dpre = o;
    o += W * LD;
    dx = o;
    o += W * LD;
    scr = o;
    // conv phases: one head's q, k, v (3W rows) and W rows more (the skip
    // product in the forward, the per-graph w_e gradient terms in the
    // backward)
    const int conv = 4 * W * LD;
    hsrc = d.Ds * LD;
    stage = round_up(hsrc + W * LD, 32);
    wacc_stride = round_up(pl.embed_size, 32);
    wacc = stage + nw * 2 * W * kStage;
    o += imax(conv, wacc + nw * wacc_stride);
    size = o;
  }
};

__device__ __forceinline__ float act(float v, int relu) {
  return relu ? fmaxf(v, 0.f) : tanhf(v);
}

// The activation's derivative, from its output.
__device__ __forceinline__ float act_grad(float y, int relu) {
  return relu ? (y > 0.f ? 1.f : 0.f) : 1.f - y * y;
}

__device__ __forceinline__ void ln_stats(const float (&m)[W], float& mu, float& r) {
  mu = 0.f;
#pragma unroll
  for (int f = 0; f < W; ++f) mu += m[f];
  mu = mu / W;
  float var = 0.f;
#pragma unroll
  for (int f = 0; f < W; ++f) {
    const float dv = m[f] - mu;
    var += dv * dv;
  }
  var = var / W;
  r = 1.f / sqrtf(var + kLnEps);
}

__device__ __forceinline__ void layer_norm(float (&m)[W], const float* scale,
                                           const float* bias) {
  float mu, r;
  ln_stats(m, mu, r);
#pragma unroll
  for (int f = 0; f < W; ++f) m[f] = (m[f] - mu) * r * scale[f] + bias[f];
}

// One edge's EmbedConv chain up to stage l, from its source's h_src `hs` and
// its masked distance: `a` gets stage l's activation output (its LayerNorm's
// input), `yp` stage l's Linear input (stage l-1's LayerNorm output; zero
// for l = 0).  P holds the EmbedConv's parameters at their blob offsets.
__device__ void edge_upto(int l, const float (&hs)[W], float dv, const float* P,
                          const ParamLayout& pl, int relu, float (&a)[W], float (&yp)[W]) {
#pragma unroll
  for (int f = 0; f < W; ++f) {
    a[f] = act(hs[f] + dv * P[pl.we1 + f], relu);
    yp[f] = 0.f;
  }
  for (int j = 1; j <= l; ++j) {
#pragma unroll
    for (int f = 0; f < W; ++f) yp[f] = a[f];
    layer_norm(yp, P + pl.ln_scale(j - 1), P + pl.ln_bias(j - 1));
    const float* WT = P + pl.embed0 + (j - 1) * pl.embed_stride;
    const float* bb = WT + W * W;
#pragma unroll
    for (int f = 0; f < W; ++f) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < W; ++k) acc = fmaf(WT[k * W + f], yp[k], acc);
      a[f] = act(acc + bb[f], relu);
    }
  }
}

// Adds the sums over the warp's 32 lanes of each lane's 16 values v to
// dst[0 .. 15]: four exchange steps halve the values a lane keeps (16
// shuffles, not 80), after which lanes 2i and 2i + 1 hold the sum of value
// i; lane 2i adds it.  The tree is fixed, so the sums repeat bit for bit.
__device__ __forceinline__ void warp_sum16_add(const float (&v)[W], float* dst, int lane) {
  float a[8], b[4], c[2];
  const bool u4 = lane & 16, u3 = lane & 8, u2 = lane & 4, u1 = lane & 2;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    a[i] = (u4 ? v[i + 8] : v[i]) + __shfl_xor_sync(kFull, u4 ? v[i] : v[i + 8], 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    b[i] = (u3 ? a[i + 4] : a[i]) + __shfl_xor_sync(kFull, u3 ? a[i] : a[i + 4], 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    c[i] = (u2 ? b[i + 2] : b[i]) + __shfl_xor_sync(kFull, u2 ? b[i] : b[i + 2], 4);
  float s = (u1 ? c[1] : c[0]) + __shfl_xor_sync(kFull, u1 ? c[0] : c[1], 2);
  s += __shfl_xor_sync(kFull, s, 1);
  if (!(lane & 1)) dst[(lane >> 1) & 15] += s;
}

// ---------------------------------------------------------------- 3xTF32

// x = hi + lo, both TF32 (10-bit mantissa); hi * hi + hi * lo + lo * hi
// keeps about FP32's precision.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A B for one 16 x 8 x 8 step in 3xTF32.  Fragments (g = lane / 4,
// q = lane % 4): a = A(g, q), A(g + 8, q), A(g, q + 4), A(g + 8, q + 4);
// b = B(q, g), B(q + 4, g); d = D(g, 2q), D(g, 2q + 1), D(g + 8, 2q),
// D(g + 8, 2q + 1).
__device__ __forceinline__ void mma3(float (&d)[4], const float (&a)[4], const float (&b)[2]) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(b[i], bh[i], bl[i]);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// d += 1 B: every row of d gets B's column sums (1 is exact in TF32, so the
// two products of B's parts are all 3xTF32 has).
__device__ __forceinline__ void mma_ones(float (&d)[4], const float (&b)[2]) {
  constexpr uint32_t one = 0x3f800000u;
  const uint32_t a[4] = {one, one, one, one};
  uint32_t bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(b[i], bh[i], bl[i]);
  mma_tf32(d, a, bl);
  mma_tf32(d, a, bh);
}

// out[n][m] (=, or += with `accumulate`) sum_k A[k][m] B(k, n) + bias(n) for
// the tile's M rows: A a panel of K rows, `bw(k, n)` and `bias(n)` read the
// staged weights, out a panel of N rows.  The warps share the 16 x 8 output
// tiles in a fixed order.
template <class BW, class Bias>
__device__ __forceinline__ void prod_panel(const float* A, int K, BW bw, int N, Bias bias,
                                           float* out, bool accumulate, const Geom& G,
                                           int warp, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int nts = N / 8, tiles = (G.Mp / 16) * nts;
  for (int t = warp; t < tiles; t += G.nw) {
    const int r0 = (t / nts) * 16 + g, r1 = r0 + 8, c0 = (t % nts) * 8 + 2 * q;
    const bool ok0 = r0 < G.M, ok1 = r1 < G.M;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    if (accumulate) {
      if (ok0) d[0] = out[c0 * G.LD + r0], d[1] = out[(c0 + 1) * G.LD + r0];
      if (ok1) d[2] = out[c0 * G.LD + r1], d[3] = out[(c0 + 1) * G.LD + r1];
    }
    const int n = (t % nts) * 8 + g;
    for (int k0 = 0; k0 < K; k0 += 8) {
      const float* a0 = A + (k0 + q) * G.LD;
      const float* a4 = a0 + 4 * G.LD;
      const float a[4] = {ok0 ? a0[r0] : 0.f, ok1 ? a0[r1] : 0.f, ok0 ? a4[r0] : 0.f,
                          ok1 ? a4[r1] : 0.f};
      const float b[2] = {bw(k0 + q, n), bw(k0 + q + 4, n)};
      mma3(d, a, b);
    }
    if (ok0) {
      out[c0 * G.LD + r0] = d[0] + bias(c0);
      out[(c0 + 1) * G.LD + r0] = d[1] + bias(c0 + 1);
    }
    if (ok1) {
      out[c0 * G.LD + r1] = d[2] + bias(c0);
      out[(c0 + 1) * G.LD + r1] = d[3] + bias(c0 + 1);
    }
  }
}

// The sums over the tile's M rows of products of panel rows: for the first
// NW rows j of the panel Bp, dw(i, j) += sum_m A[i][m] Bp[j][m] (i < 16 rows
// of the panel A); for all NS rows j, ds(j) += sum_m Bp[j][m].  dw and ds
// return references to the accumulators (the CTA's row of the scratch
// buffer), each element read and written by the one lane that owns it.
template <class DW, class DS>
__device__ __forceinline__ void prod_sum(const float* A, const float* Bp, int NW, int NS, DW dw,
                                         DS ds, const Geom& G, int warp, int lane) {
  const int g = lane >> 2, q = lane & 3;
  for (int t = warp; t < NS / 8; t += G.nw) {
    const int n0 = t * 8, c0 = n0 + 2 * q;
    const bool with_a = n0 < NW;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    if (with_a) {
      d[0] = dw(g, c0);
      d[1] = dw(g, c0 + 1);
      d[2] = dw(g + 8, c0);
      d[3] = dw(g + 8, c0 + 1);
    }
    // row 0 of s is the one kept; every row gets the same column sums
    float s[4] = {ds(c0), ds(c0 + 1), 0.f, 0.f};
    const float* brow = Bp + (n0 + g) * G.LD;
    for (int k0 = 0; k0 < G.Mp; k0 += 8) {
      const int ma = k0 + q, mb = ma + 4;
      const bool oka = ma < G.M, okb = mb < G.M;
      const float b[2] = {oka ? brow[ma] : 0.f, okb ? brow[mb] : 0.f};
      if (with_a) {
        const float* ag = A + g * G.LD;
        const float* ag8 = ag + 8 * G.LD;
        const float a[4] = {oka ? ag[ma] : 0.f, oka ? ag8[ma] : 0.f, okb ? ag[mb] : 0.f,
                            okb ? ag8[mb] : 0.f};
        mma3(d, a, b);
      }
      mma_ones(s, b);
    }
    if (with_a) {
      dw(g, c0) = d[0];
      dw(g, c0 + 1) = d[1];
      dw(g + 8, c0) = d[2];
      dw(g + 8, c0 + 1) = d[3];
    }
    if (g == 0) {
      ds(c0) = s[0];
      ds(c0 + 1) = s[1];
    }
  }
}

// ---------------------------------------------------------------- one trunk

// The pointers of one trunk's backward.
struct TrunkIO {
  const float* src_T;   // (E*Ds, B)
  const float* g_T;     // (E*C, B) output cotangent
  const float* params;  // blob
  float* dsrc_T;        // (E*Ds, B)
};

template <int NT>
struct Trunks {
  TrunkIO t[NT];
};

// Loads the tile's src into scr rows [0, Ds) and computes h_src = W1 src +
// b1 into rows [Ds, Ds + W) (the EmbedConv's parameters staged in w).
// Ends synchronised.
__device__ void load_src_hsrc(float* sm, const Geom& G, const Dims& d, const ParamLayout& pl,
                              const float* __restrict__ src_T, long long B, long long b0,
                              bool valid, int m) {
  float* scr = sm + G.scr;
  for (int i = threadIdx.x; i < d.E * d.Ds * G.NB; i += blockDim.x) {
    const int r = i / G.NB, b = i - r * G.NB;  // r = e*Ds + k
    const int e = r / d.Ds, k = r - e * d.Ds;
    const long long gb = b0 + b;
    scr[k * G.LD + e * G.NB + b] = gb < B ? src_T[r * B + gb] : 0.f;
  }
  __syncthreads();
  if (valid) {
    const float* P = sm + G.w;
    float h[W];
#pragma unroll
    for (int f = 0; f < W; ++f) h[f] = P[pl.b1 + f];
    for (int k = 0; k < d.Ds; ++k) {
      const float s = scr[k * G.LD + m];
#pragma unroll
      for (int f = 0; f < W; ++f) h[f] = fmaf(P[k * W + f], s, h[f]);
    }
#pragma unroll
    for (int f = 0; f < W; ++f) scr[G.hsrc + f * G.LD + m] = h[f];
  }
  __syncthreads();
}

// Stages conv layer l's weights (blob order) into w, Wqkv rows padded to ldw.
__device__ void stage_tc(float* sm, const Geom& G, const ParamLayout& pl,
                         const float* __restrict__ params, int l) {
  const float* src = params + pl.tc0 + l * pl.tc_stride;
  float* w = sm + G.w;
  for (int i = threadIdx.x; i < W * G.QKV; i += blockDim.x) {
    const int k = i / G.QKV, j = i - k * G.QKV;
    w[G.wq + k * G.ldw + j] = src[i];
  }
  // bqkv, w_e, Wskip, bskip lie in the same order in the blob and in w
  for (int i = threadIdx.x; i < pl.tc_stride - W * G.QKV; i += blockDim.x)
    w[G.bq + i] = src[W * G.QKV + i];
}

// Head h's column j < 3W of the q/k/v stack (q | k | v, each H*W wide).
__device__ __forceinline__ int qkv_col(const Geom& G, int h, int j) {
  return (j / W) * G.HC + h * W + (j % W);
}

// Head h's q, k, v of the tile into scr rows [0, 3W): X W_h + b_h.
__device__ __forceinline__ void prod_qkv(float* sm, const Geom& G, const float* X, int h,
                                         int warp, int lane) {
  const float* w = sm + G.w;
  prod_panel(
      X, W, [&](int k, int n) { return w[G.wq + k * G.ldw + qkv_col(G, h, n)]; }, 3 * W,
      [&](int n) { return w[G.bq + qkv_col(G, h, n)]; }, sm + G.scr, false, G, warp, lane);
}

// Thread m = (t, b): head h's attention weights of target t over the
// sources s, alpha[s][m] (the any-edge factor applied), from its query q
// (and q . w_e).  Masked logits are finfo.min, so a masked source's weight
// is exactly zero; a target with no in-edge gets zero weights.
__device__ __forceinline__ void attention_weights(float* sm, const Geom& G, const Dims& d,
                                                  const float (&q)[W], float qwe, int m, int b) {
  const float* K = sm + G.scr + W * G.LD;
  const float* dm = sm + G.dm;
  float* al = sm + G.alpha;
  const float inv_sqrt_c = 1.f / sqrtf((float)W);
  float mx = -INFINITY, any_edge = 0.f;
  for (int s = 0; s < d.E; ++s) {
    const float dv = dm[s * G.LDA + m];
    const int col = s * G.NB + b;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < W; ++c) acc = fmaf(q[c], K[c * G.LD + col], acc);
    const float lv = dv > 0.f ? (acc + dv * qwe) * inv_sqrt_c : kNeg;
    al[s * G.LDA + m] = lv;
    mx = fmaxf(mx, lv);
    any_edge = dv > 0.f ? 1.f : any_edge;
  }
  float sum = 0.f;
  for (int s = 0; s < d.E; ++s) {
    const float ex = expf(al[s * G.LDA + m] - mx);
    al[s * G.LDA + m] = ex;
    sum += ex;
  }
  const float scale = any_edge / sum;
  for (int s = 0; s < d.E; ++s) al[s * G.LDA + m] *= scale;
}

// The EmbedConv forward of target t = m / NB: x_0[t] = sum over masked
// sources of the edge chain's LayerNorm output, into the x_0 panel.
__device__ void embed_forward(float* sm, const Geom& G, const Dims& d, const ParamLayout& pl,
                              int relu, bool valid, int m, int b) {
  const float* P = sm + G.w;
  const float* hsrc = sm + G.scr + G.hsrc;
  const float* dm = sm + G.dm;
  float x0[W];
#pragma unroll
  for (int f = 0; f < W; ++f) x0[f] = 0.f;
  for (int s = 0; s < d.E; ++s) {
    const float dv = valid ? dm[s * G.LDA + m] : 0.f;
    if (!__any_sync(kFull, dv > 0.f)) continue;
    float hs[W], a[W], yp[W];
    const int col = s * G.NB + b;
#pragma unroll
    for (int f = 0; f < W; ++f) hs[f] = valid ? hsrc[f * G.LD + col] : 0.f;
    edge_upto(d.n_embed, hs, dv, P, pl, relu, a, yp);
    layer_norm(a, P + pl.ln_scale(d.n_embed), P + pl.ln_bias(d.n_embed));
    const float mv = dv > 0.f ? 1.f : 0.f;
#pragma unroll
    for (int f = 0; f < W; ++f) x0[f] = fmaf(mv, a[f], x0[f]);
  }
  if (valid) {
    float* X0 = sm + G.xs;
#pragma unroll
    for (int f = 0; f < W; ++f) X0[f * G.LD + m] = x0[f];
  }
}

// The EmbedConv backward of source s = m / NB, edge by edge over the
// targets, the dx panel holding the gradient of x_0: each stage's chain is
// recomputed from the edge's input; LayerNorm, bias, w_e1, b1 and W1
// gradients are summed over the warp (warp_sum16_add) into the warp's
// accumulator, the embed Linear weights' gradients over the warp's 32 edges
// by one tensor-core product per edge step; the distance gradient is added
// to dadj[s][t] and dsrc stored.  Every lane of a warp runs the loops (warp
// operations inside), a lane without a column with zero inputs.
__device__ void embed_backward(float* sm, const Geom& G, const Dims& d, const ParamLayout& pl,
                               int relu, bool valid, int m, int e, int b,
                               float* __restrict__ dsrc_T, long long B, long long b0) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int g = lane >> 2, q = lane & 3;
  const float* P = sm + G.w;
  const float* src = sm + G.scr;
  const float* hsrc = sm + G.scr + G.hsrc;
  const float* dm = sm + G.dm;
  const float* dx = sm + G.dx;
  float* dadj = sm + G.dadj;
  float* st = sm + G.scr + G.stage + warp * 2 * W * kStage;
  float* wa = sm + G.scr + G.wacc + warp * G.wacc_stride;

  float hs[W], dh[W];
#pragma unroll
  for (int f = 0; f < W; ++f) {
    hs[f] = valid ? hsrc[f * G.LD + m] : 0.f;
    dh[f] = 0.f;
  }
  for (int t = 0; t < d.E; ++t) {
    const int col = t * G.NB + b;
    const float dv = valid ? dm[e * G.LDA + col] : 0.f;
    if (!__any_sync(kFull, dv > 0.f)) continue;
    const float mv = dv > 0.f ? 1.f : 0.f;
    float dy[W];
#pragma unroll
    for (int f = 0; f < W; ++f) dy[f] = valid ? mv * dx[f * G.LD + col] : 0.f;
    float ddv = 0.f;
    for (int l = d.n_embed; l >= 0; --l) {
      float a[W], yp[W], tmp[W];
      edge_upto(l, hs, dv, P, pl, relu, a, yp);
      float mu, r;
      ln_stats(a, mu, r);
      const float* sc = P + pl.ln_scale(l);
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int f = 0; f < W; ++f) {
        const float xh = (a[f] - mu) * r;
        const float dxh = dy[f] * sc[f];
        m1 += dxh;
        m2 = fmaf(dxh, xh, m2);
        tmp[f] = dy[f] * xh;
      }
      warp_sum16_add(tmp, wa + pl.ln_scale(l), lane);
      warp_sum16_add(dy, wa + pl.ln_bias(l), lane);
      m1 /= W;
      m2 /= W;
      float dz[W];
#pragma unroll
      for (int f = 0; f < W; ++f) {
        const float xh = (a[f] - mu) * r;
        dz[f] = r * (dy[f] * sc[f] - m1 - xh * m2) * act_grad(a[f], relu);
      }
      if (l >= 1) {
        const int woff = pl.embed0 + (l - 1) * pl.embed_stride;
        const float* WT = P + woff;
        warp_sum16_add(dz, wa + woff + W * W, lane);
        // dW_l (in, out) += sum over the warp's edges of yp dz^T
#pragma unroll
        for (int f = 0; f < W; ++f) {
          st[f * kStage + lane] = yp[f];
          st[(W + f) * kStage + lane] = dz[f];
        }
        __syncwarp();
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int c0 = nt * 8 + 2 * q;
          float* o0 = wa + woff + g * W + c0;
          float* o8 = o0 + 8 * W;
          float acc[4] = {o0[0], o0[1], o8[0], o8[1]};
#pragma unroll
          for (int k0 = 0; k0 < kWarp; k0 += 8) {
            const float av[4] = {st[g * kStage + k0 + q], st[(g + 8) * kStage + k0 + q],
                                 st[g * kStage + k0 + q + 4], st[(g + 8) * kStage + k0 + q + 4]};
            const float* brow = st + (W + nt * 8 + g) * kStage;
            const float bv[2] = {brow[k0 + q], brow[k0 + q + 4]};
            mma3(acc, av, bv);
          }
          o0[0] = acc[0];
          o0[1] = acc[1];
          o8[0] = acc[2];
          o8[1] = acc[3];
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < W; ++k) {
          float acc = 0.f;
#pragma unroll
          for (int f = 0; f < W; ++f) acc = fmaf(WT[k * W + f], dz[f], acc);
          dy[k] = acc;
        }
      } else {
#pragma unroll
        for (int f = 0; f < W; ++f) {
          tmp[f] = dz[f] * dv;
          ddv = fmaf(dz[f], P[pl.we1 + f], ddv);
          dh[f] += dz[f];
        }
        warp_sum16_add(tmp, wa + pl.we1, lane);
      }
    }
    if (valid) dadj[e * G.LDA + col] += ddv;
  }

  // lin1: h_src = W1 src + b1 per source entity
  const long long gb = b0 + b;
  if (valid && gb < B) {
    for (int k = 0; k < d.Ds; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int f = 0; f < W; ++f) acc = fmaf(P[k * W + f], dh[f], acc);
      dsrc_T[(long long)(e * d.Ds + k) * B + gb] = acc;
    }
  }
  warp_sum16_add(dh, wa + pl.b1, lane);
  for (int k = 0; k < d.Ds; ++k) {
    const float s = valid ? src[k * G.LD + m] : 0.f;
    float tmp[W];
#pragma unroll
    for (int f = 0; f < W; ++f) tmp[f] = s * dh[f];
    warp_sum16_add(tmp, wa + k * W, lane);
  }
}

// One trunk's backward over the tile of NB graphs from b0, whose masked
// distances are in dm: recomputes the forward keeping x_0 .. x_{n_tc - 1},
// runs the conv layers' backward in reverse order (each recomputing its
// q/k/v and attention weights head by head), then the EmbedConv's; adds
// the parameter gradients, summed over the tile, to `prow` (blob order),
// the distance gradients to dadj, and stores dsrc.  Ends synchronised.
__device__ void trunk_tile_backward(float* sm, const Geom& G, const Dims& d,
                                    const ParamLayout& pl, const TrunkIO& io, float* prow,
                                    long long B, long long b0, int embed_relu, int gnn_relu) {
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const bool valid = tid < G.M;
  const int m = tid, e = valid ? m / G.NB : 0, b = valid ? m - e * G.NB : 0;
  const float inv_h = 1.f / (float)d.H, inv_sqrt_c = 1.f / sqrtf((float)W);
  const float* __restrict__ params = io.params;
  float* w = sm + G.w;
  float* scr = sm + G.scr;
  float* dpre = sm + G.dpre;
  float* dx = sm + G.dx;
  float* dm = sm + G.dm;
  float* dadj = sm + G.dadj;
  float* alpha = sm + G.alpha;
  float* us = sm + G.us;

  // ---- forward: EmbedConv
  __syncthreads();
  for (int i = tid; i < pl.embed_size; i += blockDim.x) w[i] = params[i];
  load_src_hsrc(sm, G, d, pl, io.src_T, B, b0, valid, m);
  embed_forward(sm, G, d, pl, embed_relu, valid, m, b);

  // ---- forward: the conv layers; the last turns its output into dpre
  for (int l = 0; l < d.n_tc; ++l) {
    __syncthreads();
    stage_tc(sm, G, pl, params, l);
    __syncthreads();
    const float* X = sm + G.xs + l * W * G.LD;
    prod_panel(
        X, W, [&](int k, int n) { return w[G.wsk + k * W + n]; }, W, [](int) { return 0.f; },
        scr + 3 * W * G.LD, false, G, warp, lane);
    float acc[W];
    for (int h = 0; h < d.H; ++h) {
      if (h > 0) __syncthreads();
      prod_qkv(sm, G, X, h, warp, lane);
      __syncthreads();
      if (valid) {
        const float* Q = scr;
        const float* V = scr + 2 * W * G.LD;
        float q[W], we[W];
        float qwe = 0.f;
#pragma unroll
        for (int c = 0; c < W; ++c) {
          q[c] = Q[c * G.LD + m];
          we[c] = w[G.we + h * W + c];
          qwe = fmaf(q[c], we[c], qwe);
          if (h == 0) acc[c] = scr[(3 * W + c) * G.LD + m] + w[G.bsk + c];
        }
        attention_weights(sm, G, d, q, qwe, m, b);
        float o[W];
#pragma unroll
        for (int c = 0; c < W; ++c) o[c] = 0.f;
        float ad = 0.f;
        for (int s = 0; s < d.E; ++s) {
          const float a = alpha[s * G.LDA + m];
          ad = fmaf(a, dm[s * G.LDA + m], ad);
          const int col = s * G.NB + b;
#pragma unroll
          for (int c = 0; c < W; ++c) o[c] = fmaf(a, V[c * G.LD + col], o[c]);
        }
#pragma unroll
        for (int c = 0; c < W; ++c) acc[c] += (o[c] + ad * we[c]) * inv_h;
      }
    }
    if (valid) {
      if (l + 1 < d.n_tc) {
        float* Y = sm + G.xs + (l + 1) * W * G.LD;
#pragma unroll
        for (int c = 0; c < W; ++c) Y[c * G.LD + m] = act(acc[c], gnn_relu);
      } else {
        const long long gb = b0 + b;
#pragma unroll
        for (int c = 0; c < W; ++c) {
          const float gv = gb < B ? io.g_T[(long long)(e * W + c) * B + gb] : 0.f;
          dpre[c * G.LD + m] = gv * act_grad(act(acc[c], gnn_relu), gnn_relu);
        }
      }
    }
  }

  // ---- backward: the conv layers, last first
  for (int l = d.n_tc - 1; l >= 0; --l) {
    __syncthreads();
    if (l + 1 < d.n_tc) {
      stage_tc(sm, G, pl, params, l);
      if (valid) {
        const float* Y = sm + G.xs + (l + 1) * W * G.LD;
#pragma unroll
        for (int c = 0; c < W; ++c)
          dpre[c * G.LD + m] = dx[c * G.LD + m] * act_grad(Y[c * G.LD + m], gnn_relu);
      }
      __syncthreads();
    }
    const float* X = sm + G.xs + l * W * G.LD;
    float* tc = prow + pl.tc0 + l * pl.tc_stride;
    const int o_bq = W * G.QKV, o_we = o_bq + G.QKV, o_wsk = o_we + G.HC, o_bsk = o_wsk + W * W;
    // the skip Linear: dx = dpre Wskip^T; dWskip += X^T dpre, dbskip += sum dpre
    prod_panel(
        dpre, W, [&](int k, int n) { return w[G.wsk + n * W + k]; }, W, [](int) { return 0.f; },
        dx, false, G, warp, lane);
    prod_sum(
        X, dpre, W, W, [&](int i, int j) -> float& { return tc[o_wsk + i * W + j]; },
        [&](int j) -> float& { return tc[o_bsk + j]; }, G, warp, lane);
    for (int h = 0; h < d.H; ++h) {
      if (h > 0) __syncthreads();
      prod_qkv(sm, G, X, h, warp, lane);
      __syncthreads();
      // thread m = (t, b): the weights again, then the softmax backward, the
      // distance terms and dq; the w_e gradient terms into scr rows [3W, 4W)
      float dq[W];
      if (valid) {
        const float* Q = scr;
        const float* K = scr + W * G.LD;
        const float* V = scr + 2 * W * G.LD;
        float q[W], we[W], dp[W];
        float qwe = 0.f, dpwe = 0.f;
#pragma unroll
        for (int c = 0; c < W; ++c) {
          q[c] = Q[c * G.LD + m];
          we[c] = w[G.we + h * W + c];
          dp[c] = dpre[c * G.LD + m];
          qwe = fmaf(q[c], we[c], qwe);
          dpwe = fmaf(dp[c], we[c], dpwe);
        }
        dpwe *= inv_h;
        attention_weights(sm, G, d, q, qwe, m, b);
        float S = 0.f;
        for (int s = 0; s < d.E; ++s) {
          const int col = s * G.NB + b;
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < W; ++c) acc = fmaf(dp[c], V[c * G.LD + col], acc);
          const float da = acc * inv_h + dm[s * G.LDA + m] * dpwe;
          us[s * G.LDA + m] = da;
          S = fmaf(alpha[s * G.LDA + m], da, S);
        }
        float ad = 0.f, wsum = 0.f;
#pragma unroll
        for (int c = 0; c < W; ++c) dq[c] = 0.f;
        for (int s = 0; s < d.E; ++s) {
          const int col = s * G.NB + b;
          const float dv = dm[s * G.LDA + m], a = alpha[s * G.LDA + m];
          const float u = dv > 0.f ? a * (us[s * G.LDA + m] - S) * inv_sqrt_c : 0.f;
          us[s * G.LDA + m] = u;
          ad = fmaf(a, dv, ad);
          wsum = fmaf(u, dv, wsum);
          dadj[s * G.LDA + m] += u * qwe + a * dpwe;
#pragma unroll
          for (int c = 0; c < W; ++c) dq[c] = fmaf(u, K[c * G.LD + col], dq[c]);
        }
#pragma unroll
        for (int c = 0; c < W; ++c) {
          dq[c] = fmaf(wsum, we[c], dq[c]);
          scr[(3 * W + c) * G.LD + m] = ad * inv_h * dp[c] + wsum * q[c];
        }
      }
      __syncthreads();
      // thread m = (s, b): dk_s and dv_s
      float dk[W], dvv[W];
      if (valid) {
        const float* Q = scr;
#pragma unroll
        for (int c = 0; c < W; ++c) dk[c] = dvv[c] = 0.f;
        for (int t = 0; t < d.E; ++t) {
          const int col = t * G.NB + b;
          const float u = us[e * G.LDA + col], a = alpha[e * G.LDA + col];
#pragma unroll
          for (int c = 0; c < W; ++c) {
            dk[c] = fmaf(u, Q[c * G.LD + col], dk[c]);
            dvv[c] = fmaf(a, dpre[c * G.LD + col], dvv[c]);
          }
        }
      }
      __syncthreads();
      if (valid) {
#pragma unroll
        for (int c = 0; c < W; ++c) {
          scr[c * G.LD + m] = dq[c];
          scr[(W + c) * G.LD + m] = dk[c];
          scr[(2 * W + c) * G.LD + m] = dvv[c] * inv_h;
        }
      }
      __syncthreads();
      // dx += dqkv_h W_h^T; dW_h += X^T dqkv_h, dbqkv_h and dw_e,h += column sums
      prod_panel(
          scr, 3 * W, [&](int k, int n) { return w[G.wq + n * G.ldw + qkv_col(G, h, k)]; }, W,
          [](int) { return 0.f; }, dx, true, G, warp, lane);
      prod_sum(
          X, scr, 3 * W, 4 * W,
          [&](int i, int j) -> float& { return tc[i * G.QKV + qkv_col(G, h, j)]; },
          [&](int j) -> float& {
            return j < 3 * W ? tc[o_bq + qkv_col(G, h, j)] : tc[o_we + h * W + j - 3 * W];
          },
          G, warp, lane);
    }
  }

  // ---- backward: EmbedConv, the dx panel holding the gradient of x_0
  __syncthreads();
  for (int i = tid; i < pl.embed_size; i += blockDim.x) w[i] = params[i];
  for (int i = tid; i < G.nw * G.wacc_stride; i += blockDim.x) scr[G.wacc + i] = 0.f;
  load_src_hsrc(sm, G, d, pl, io.src_T, B, b0, valid, m);
  embed_backward(sm, G, d, pl, embed_relu, valid, m, e, b, io.dsrc_T, B, b0);
  __syncthreads();
  for (int i = tid; i < pl.embed_size; i += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < G.nw; ++k) s += scr[G.wacc + k * G.wacc_stride + i];
    prow[i] += s;
  }
  __syncthreads();
}

// The trunk's code compiled once, out of line, for the dual backward to run
// for both trunks: inlined in a loop it needed 420 bytes of spills and the
// launch took about 17% longer (PERF.md §6); the single backward inlines it.
__device__ __noinline__ void trunk_tile_backward_outlined(float* sm, const Geom& G, const Dims& d,
                                                          const ParamLayout& pl,
                                                          const TrunkIO& io, float* prow,
                                                          long long B, long long b0,
                                                          int embed_relu, int gnn_relu) {
  trunk_tile_backward(sm, G, d, pl, io, prow, B, b0, embed_relu, gnn_relu);
}

// The CTA's loop over its tiles (tile i of the grid's CTA c is graphs
// (c + i * CTAs) * NB ...): per tile the adjacency is read once, the edge
// mask kept as the masked distance, and each of the NT trunks' backward run
// in turn; the distance gradient of all NT is summed and stored.  The CTA's
// parameter gradients, NT * n_params floats, accumulate in its row of
// `partial`, each word always added to by the same thread, in tile order.
template <int NT>
__device__ __forceinline__ void backward_ctas(const Trunks<NT>& tr,
                                              const float* __restrict__ adj_T,
                                              float* __restrict__ dadj_T, float* partial,
                                              long long B, const Dims& d, float max_edge_dist,
                                              int embed_relu, int gnn_relu, int nb) {
  extern __shared__ float sm[];
  const ParamLayout pl(d);
  const Geom G(d, pl, nb);
  const int np = pl.total;
  float* row = partial + (long long)blockIdx.x * NT * np;
  for (int i = threadIdx.x; i < NT * np; i += blockDim.x) row[i] = 0.f;
  const int n_adj = d.E * d.E;
  for (long long b0 = (long long)blockIdx.x * nb; b0 < B; b0 += (long long)gridDim.x * nb) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_adj * nb; i += blockDim.x) {
      const int r = i / nb, b = i - r * nb;  // r = s*E + t
      const int s = r / d.E, t = r - s * d.E;
      const long long gb = b0 + b;
      const float dv = gb < B ? adj_T[r * B + gb] : 0.f;
      const int o = s * G.LDA + t * nb + b;
      sm[G.dm + o] = (dv > 0.f && dv < max_edge_dist) ? dv : 0.f;
      sm[G.dadj + o] = 0.f;
    }
    if constexpr (NT == 1) {
      trunk_tile_backward(sm, G, d, pl, tr.t[0], row, B, b0, embed_relu, gnn_relu);
    } else {
#pragma unroll 1
      for (int k = 0; k < NT; ++k)
        trunk_tile_backward_outlined(sm, G, d, pl, tr.t[k], row + k * np, B, b0, embed_relu,
                                     gnn_relu);
    }
    for (int i = threadIdx.x; i < n_adj * nb; i += blockDim.x) {
      const int r = i / nb, b = i - r * nb;
      const int s = r / d.E, t = r - s * d.E;
      const long long gb = b0 + b;
      const int o = s * G.LDA + t * nb + b;
      if (gb < B) dadj_T[r * B + gb] = sm[G.dm + o] > 0.f ? sm[G.dadj + o] : 0.f;
    }
  }
}

// dparams[i] = sum over rows r of partial[r, i], rows in order.
__global__ void sum_rows_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                int rows, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += partial[(long long)r * n + i];
  out[i] = s;
}

// ---------------------------------------------------------------- host side

// A device's SM count and shared memory per SM and reserved per CTA, read
// at its first launch and kept.
struct DeviceInfo {
  int sms = 0, smem_sm = 0, reserved = 0;
};
constexpr int kMaxDevices = 64;
DeviceInfo g_devices[kMaxDevices];
int g_smem_set[kMaxDevices];  // the dynamic shared memory the kernel may use
std::mutex g_devices_mutex;

int device_info(int* dev, DeviceInfo* info) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  if (*dev >= kMaxDevices) return -6;
  std::lock_guard<std::mutex> lock(g_devices_mutex);
  DeviceInfo& di = g_devices[*dev];
  if (di.sms == 0) {
    if ((err = cudaDeviceGetAttribute(&di.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                      *dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&di.reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                                      *dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&di.sms, cudaDevAttrMultiProcessorCount, *dev)) !=
            cudaSuccess) {
      di.sms = 0;
      return (int)err;
    }
  }
  *info = di;
  return 0;
}

// The launch shape: graphs per CTA, threads, dynamic shared memory, and the
// CTAs an SM holds by shared memory, threads and registers.
struct Plan {
  int nb = 0, threads = 0, smem = 0, per_sm = 0;
};

// Picks NB, the graphs per CTA, that puts the most graphs on an SM by shared
// memory, threads (at most kMaxThreads a CTA) and registers at the launch
// bound, the larger NB on a tie.  The plan depends on the dimensions and the
// device only, not on the kernel, so the single and the dual backward tile a
// batch alike.
int configure(const Dims& d, int F1, int C, const DeviceInfo& di, Plan* plan) {
  if (F1 != W || C != W) return -1;
  if (d.E < 1 || d.E > kMaxEntities || d.Ds < 1 || d.H < 1) return -2;
  if (d.n_embed < 0 || d.n_embed > kMaxEmbedLayers || d.n_tc < 1 || d.n_tc > kMaxTcLayers)
    return -4;
  const ParamLayout pl(d);
  Plan best;
  for (int nb = kMaxGraphsPerCta; nb >= 1; --nb) {
    const Geom G(d, pl, nb);
    const long long smem = (long long)G.size * (long long)sizeof(float);
    if (G.T > kMaxThreads || smem > kSmemLimit) continue;
    const int per_sm = imin(imin(di.smem_sm / ((int)smem + di.reserved),
                                 kMaxThreadsPerSm / G.T),
                            imin(kRegsPerSm / (kRegsPerWarp * G.nw), kMaxCtasPerSm));
    if (per_sm >= 1 && nb * per_sm > best.nb * best.per_sm)
      best = {nb, G.T, (int)smem, per_sm};
  }
  if (best.nb == 0) return -3;
  *plan = best;
  return 0;
}

// The plan of `kernel` over B graphs and the CTAs it launches (the rows of
// the scratch buffer it needs): all the CTAs the card holds at once, or one
// a tile where there are fewer tiles.
template <typename Kernel>
int grid_for(Kernel kernel, const Dims& d, int F1, int C, long long B, Plan* plan,
             int* grid) {
  int dev = 0;
  DeviceInfo di;
  int rc = device_info(&dev, &di);
  if (rc != 0) return rc;
  if ((rc = configure(d, F1, C, di, plan)) != 0) return rc;
  {
    std::lock_guard<std::mutex> lock(g_devices_mutex);
    if (g_smem_set[dev] < plan->smem) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan->smem);
      if (err != cudaSuccess) return (int)err;
      g_smem_set[dev] = plan->smem;
    }
  }
  const long long ctas = (long long)di.sms * plan->per_sm;
  const long long tiles = (B + plan->nb - 1) / plan->nb;
  *grid = (int)(ctas < tiles ? ctas : tiles);
  return 0;
}

// What the compiler and the card make of the kernel at these dimensions:
// registers a thread, local memory a thread, and the CTAs an SM actually
// holds (beside the plan's shared-memory and thread count).
template <typename Kernel>
int kernel_attributes(Kernel kernel, const Dims& d, int F1, int C, int* threads, int* regs,
                      int* local_bytes, int* ctas_per_sm, int* planned_per_sm) {
  Plan plan;
  int grid = 0;
  int rc = grid_for(kernel, d, F1, C, 1, &plan, &grid);
  if (rc != 0) return rc;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, plan.threads,
                                                           plan.smem)) != cudaSuccess)
    return (int)err;
  *threads = plan.threads;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *planned_per_sm = plan.per_sm;
  return 0;
}

}  // namespace
