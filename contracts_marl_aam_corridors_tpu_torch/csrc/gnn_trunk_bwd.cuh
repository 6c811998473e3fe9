// Device code of the GNN trunk backward, shared by csrc/gnn_trunk_bwd.cu (one
// trunk per launch) and csrc/gnn_trunk_dual_bwd.cu (the actor and critic
// trunks in one launch): the backward's tile geometry and shared-memory
// plan, its per-thread softmax, LayerNorm and distance steps, one trunk's
// backward over a tile of graphs, the CTA loop over tiles, the in-order row
// sum and the launch configuration.  The forward it recomputes, the
// parameter layout, the 3xTF32 products over a tile's panels and the plan
// search are csrc/gnn_trunk_panel.cuh's, shared with the forward kernel
// (csrc/gnn_trunk_fwd.cu); that header describes the panel layout.  The
// backward's own products are dX = dQKV_h W_h^T + dpre Wskip^T, and dW_h =
// X^T dQKV_h, dWskip = X^T dpre with K = M, whose bias and w_e gradients
// come out of the same products as column sums (a product with a matrix of
// ones); the distance gradient is a plane [s][t*NB + b] as the distances
// are.
#pragma once

#include "gnn_trunk_panel.cuh"

namespace {

constexpr int kMaxGraphsPerCta = 32;
// At most 256 threads a CTA, so a thread may keep up to 255 registers: 8
// warps an SM at the launch bound, whatever the compiler makes of the
// kernel.
constexpr int kMaxThreads = 256;
constexpr int kMaxRegs = 255;
// Row stride of a warp's staging rows (32 lanes + 4): the tensor-core
// fragments of a (16 x 32) block then read 32 distinct banks.
constexpr int kStage = kWarp + 4;

// The backward's shared-memory plan, in floats, beside the panel geometry.
struct Geom : PanelGeom {
  int dadj, us, xs, dpre, dx;
  // inside scr during the EmbedConv phases: src (Ds rows), h_src (W rows),
  // each warp's staging rows and its parameter-gradient accumulator
  int stage, wacc, wacc_stride;
  __host__ __device__ Geom(const Dims& d, const ParamLayout& pl, int nb) : PanelGeom(d, nb) {
    int o = 0;
    w = o;
    o += round_up(imax(tc_floats(), pl.embed_size), 32);
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
    stage = round_up(hsrc + W * LD, 32);
    wacc_stride = round_up(pl.embed_size, 32);
    wacc = stage + nw * 2 * W * kStage;
    o += imax(conv, wacc + nw * wacc_stride);
    size = o;
  }
};

// The activation's derivative, from its output.
__device__ __forceinline__ float act_grad(float y, int relu) {
  return relu ? (y > 0.f ? 1.f : 0.f) : 1.f - y * y;
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

// ---------------------------------------------------------------- 3xTF32 sums

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

// The sums over the tile's M rows of products of panel rows: for the first
// NW rows j of the panel Bp, dw(i, j) += sum_m A[i][m] Bp[j][m] (i < 16 rows
// of the panel A); for all NS rows j, ds(j) += sum_m Bp[j][m].  dw and ds
// return references to the accumulators (the CTA's row of the scratch
// buffer), each element read and written by the one lane that owns it.
// The tile's sums start from zero and are added to the accumulators once
// (read before the products, so the load waits on nothing): a CTA's
// accumulator then takes one rounding a tile, not one a k-step of every
// tile (with the running sum in the products, the error of a leaf grew
// with the graphs a CTA takes and reached the JAX bar at 64,000 graphs of
// E = 22 and 128,000 of E = 13).
template <class DW, class DS>
__device__ __forceinline__ void prod_sum(const float* A, const float* Bp, int NW, int NS, DW dw,
                                         DS ds, const Geom& G, int warp, int lane) {
  const int g = lane >> 2, q = lane & 3;
  for (int t = warp; t < NS / 8; t += G.nw) {
    const int n0 = t * 8, c0 = n0 + 2 * q;
    const bool with_a = n0 < NW;
    float d[4] = {0.f, 0.f, 0.f, 0.f}, run[4] = {0.f, 0.f, 0.f, 0.f};
    if (with_a) {
      run[0] = dw(g, c0);
      run[1] = dw(g, c0 + 1);
      run[2] = dw(g + 8, c0);
      run[3] = dw(g + 8, c0 + 1);
    }
    const float run_s[2] = {ds(c0), ds(c0 + 1)};
    // row 0 of s is the one kept; every row gets the same column sums
    float s[4] = {0.f, 0.f, 0.f, 0.f};
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
      dw(g, c0) = run[0] + d[0];
      dw(g, c0 + 1) = run[1] + d[1];
      dw(g + 8, c0) = run[2] + d[2];
      dw(g + 8, c0 + 1) = run[3] + d[3];
    }
    if (g == 0) {
      ds(c0) = run_s[0] + s[0];
      ds(c0 + 1) = run_s[1] + s[1];
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
  embed_forward(sm, G, d, pl, embed_relu, valid, m, b, sm + G.xs);

  // ---- forward: the conv layers; the last turns its output into dpre
  for (int l = 0; l < d.n_tc; ++l) {
    __syncthreads();
    stage_tc(w, G, pl, params, l);
    __syncthreads();
    float acc[W];
    conv_forward<true>(sm, G, d, w, sm + G.xs + l * W * G.LD, scr + 3 * W * G.LD, valid, m, b,
                       warp, lane, acc);
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
      stage_tc(w, G, pl, params, l);
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
      prod_qkv(sm, G, w, X, h, warp, lane);
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

// Picks NB, the graphs per CTA, that puts the most graphs on an SM by shared
// memory, threads (at most kMaxThreads a CTA) and registers at the launch
// bound, the larger NB on a tie.  The plan depends on the dimensions and the
// device only, not on the kernel, so the single and the dual backward tile a
// batch alike.
int configure(const Dims& d, int F1, int C, const DeviceInfo& di, Plan* plan) {
  const int rc = check_dims(d, F1, C);
  if (rc != 0) return rc;
  return best_plan<Geom>(d, di, kMaxGraphsPerCta, kMaxThreads, kMaxRegs, plan);
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
  if ((rc = allow_smem(kernel, dev, plan->smem)) != 0) return rc;
  const long long ctas = (long long)di.sms * plan->per_sm;
  const long long tiles = (B + plan->nb - 1) / plan->nb;
  *grid = (int)(ctas < tiles ? ctas : tiles);
  return 0;
}

}  // namespace
