// Shared device machinery of the fused PDE-residual kernels (sm_90a).
//
// Included by ns_residual.cu (Navier–Stokes head) and poisson_residual.cu
// (Poisson head); each source is its own translation unit and shared library.
// taylor_bundle.cu (kernel 5) takes Net, Weights, make_net, tanh_t, the
// stream-grouped warp tiles (StreamTile), the tile constants and allow_smem,
// and has its own layout, layer jobs, kernel and plan.
// What is here is independent of the PDE:
//   * the shared-memory layout of one block (`Layout`, mirrored by
//     tile_layout in tpinn_torch/kernels/mlp_bundle.py);
//   * warp-tile matrix products: DMMA tiles on the float64 tensor cores
//     (m16n8k8; the stream-grouped layer products stack two streams in one
//     m16n8k8 tile), register tiles of IEEE FFMA in float32 (no TF32);
//   * the one-pass kernel `residual_kernel<H, BWD>`: a block walks tiles of
//     P points and keeps every layer's Taylor streams of a tile as one matrix
//     with stream-major rows (row = s·P + p; value, one gradient stream per
//     input column, one Hessian-diagonal stream per spatial column), so a
//     layer is one product Z = A·W, a tanh-Taylor epilogue and, backward,
//     the elementwise cotangent rule and two products dW += Aᵀ·DZ and
//     dA = DZ·Wᵀ; widths are padded to multiples of 8 with zero weights, so
//     padded neurons carry exact zeros;
//   * the block partials and their fixed-order sum over blocks by the last
//     block to finish (an integer ticket), so one call is one launch and two
//     calls at the same parameters agree bit for bit;
//   * the launch plan and the launch itself.
// The PDE enters through a head policy H (see NSHead / PoissonHead), which
// gives the element type T, the input width D, the head width kDOut, the
// number of squared-residual sums kNsq, an extra per-point input column
// (kExtra, the Poisson forcing), the per-point residual rows, the head-stream
// cotangents, and the range of head streams [kLiveLo, kLiveHi) that can
// carry a nonzero cotangent: the head products skip the other rows.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "ptx.cuh"

namespace {

constexpr int kMaxLayers = 8;  // Dense layers, head included
constexpr int kMaxWidth = 64;  // any layer's output width
constexpr int kNh = 2;  // Hessian-diagonal streams: the two spatial columns
constexpr int kThreads = 512;  // threads of a residual block
constexpr int kWarps = kThreads / 32;
constexpr int kSkew = 4;  // row stride of a stream matrix: padded width + 4
constexpr int kSmemLimit = 227 * 1024;  // dynamic shared memory of a block
constexpr int kTileCands[] = {32, 16, 8, 4, 2, 1};  // points per tile

struct Net {
  int n_layers;
  int widths[kMaxLayers + 1];
};

template <typename T>
struct Weights {
  const T* w[kMaxLayers];
  const T* b[kMaxLayers];
};

__device__ __forceinline__ float tanh_t(float v) { return tanhf(v); }
__device__ __forceinline__ double tanh_t(double v) { return tanh(v); }

__host__ __device__ inline int pad8(int v) { return (v + 7) & ~7; }
__host__ __device__ inline int align4(int v) { return (v + 3) & ~3; }

// Shared-memory layout of one block, in elements of T.  Identical on host
// and device.  Every region starts at a multiple of four elements.
struct Layout {
  int P, R;                   // points per tile; stream rows pad8(S·P)
  int wp[kMaxLayers + 1];     // padded widths: wp[0] = d_in, wp[l] = pad8
  int ld[kMaxLayers + 1];     // row stride of a width-wp[l] matrix: wp + kSkew
  int w_off[kMaxLayers];      // W_l: wp[l] rows of stride ld[l+1], zero pads
  int b_off[kMaxLayers];      // b_l: wp[l+1]
  int g_off[kMaxLayers];      // dW_l (widths, dense), then db_l, from the
                              // accumulators' start (BWD)
  int acc0;                   // the accumulators (acc_smem) and the zeroed
                              // region start here
  int xc;                     // per-point input columns: d_in (+ forcing)
  int xb[2];                  // two P x xc input buffers (double-buffered)
  int act[kMaxLayers];        // hidden layer l's output streams, R x ld[l+1]
  int aux[kMaxLayers];        // its (tanh', z_g, z_h) rows, R x ld[l+1]
  int head;                   // head streams, R x ld[L]
  int ldm;                    // max ld[l], l >= 1
  int cz[2];                  // stream cotangents of layers l even / odd,
                              // R x ldm each (BWD)
  int sq;                     // P x n_sq squared residuals of a tile
  int total;
  int n_acc;                  // accumulators: dW/db in out's order, n_sq sums

  // With acc_smem the accumulators take n_acc elements of shared memory;
  // else they live in the block's own slice of the partials.
  __host__ __device__ void build(const Net& net, int d_in, int n_sq,
                                 int x_extra, int points, bool bwd,
                                 bool acc_smem) {
    const int S = 1 + d_in + kNh;
    const int L = net.n_layers;
    P = points;
    R = pad8(S * P);
    wp[0] = d_in;
    ld[0] = d_in;
    ldm = 0;
    for (int l = 1; l <= L; ++l) {
      wp[l] = pad8(net.widths[l]);
      ld[l] = wp[l] + kSkew;
      if (ld[l] > ldm) ldm = ld[l];
    }
    int off = 0;
    for (int l = 0; l < L; ++l) {
      w_off[l] = off;
      off += wp[l] * ld[l + 1];
      b_off[l] = off;
      off += wp[l + 1];
    }
    acc0 = off;
    n_acc = 0;
    for (int l = 0; l < L; ++l) {
      g_off[l] = n_acc;
      if (bwd) n_acc += (net.widths[l] + 1) * net.widths[l + 1];
    }
    n_acc += n_sq;
    if (acc_smem) off += align4(n_acc);
    xc = d_in + x_extra;
    xb[0] = off;
    off += align4(P * xc);
    xb[1] = off;
    off += align4(P * xc);
    for (int l = 0; l + 1 < L; ++l) {
      act[l] = off;
      off += R * ld[l + 1];
      aux[l] = off;
      off += R * ld[l + 1];
    }
    head = off;
    off += R * ld[L];
    cz[0] = cz[1] = off;
    if (bwd) {
      cz[0] = off;
      off += R * ldm;
      cz[1] = off;
      off += R * ldm;
    }
    sq = off;
    off += align4(P * n_sq);
    total = off;
  }
};

// ---------------------------------------------------------------------------
// Warp-tile products C (+)= A·B with A(m, k) = a[m·am + k·ak] and
// B(k, n) = b[k·bk + n·bn]; C(m, n) = c[m·cm + n·cn].
// ---------------------------------------------------------------------------

template <typename T>
struct Tile;

// float64: one 16x8 DMMA tile (m16n8k8); N a multiple of 8, K of 8; rows
// past M read a clamped row and are not stored.
template <>
struct Tile<double> {
  static constexpr int TM = 16, TN = 8, NV = 4;
  __device__ static int row(int lane, int v) { return (lane >> 2) + 8 * (v >> 1); }
  __device__ static int col(int lane, int v) { return 2 * (lane & 3) + (v & 1); }
  __device__ static void run(double c[NV], const double* a, int am, int ak,
                             const double* b, int bk, int bn, int K, int lane,
                             int m_left, int) {
    const int g = lane >> 2, q = lane & 3;
    const double* a0 = a + g * am + q * ak;
    const double* a1 = a + min(g + 8, m_left - 1) * am + q * ak;
    const double* bp = b + q * bk + g * bn;
    const int s4a = 4 * ak, s4b = 4 * bk;
    for (int k = 0; k < K; k += 8, a0 += 2 * s4a, a1 += 2 * s4a, bp += 2 * s4b)
      dmma_16x8x8(c[0], c[1], c[2], c[3], a0[0], a1[0], a0[s4a], a1[s4a], bp[0],
                  bp[s4b]);
  }
};

// float32: a 16x8 tile, 2x2 outputs per lane (rows t/4 and t/4 + 8,
// columns 2·(t%4) and 2·(t%4) + 1, as the float64 tile), IEEE FFMA.  Small
// tiles give a product over a long contraction (a tile's stream rows) to
// as many warps as they can.  Rows and columns past M, N read clamped
// operands and are not stored.
template <>
struct Tile<float> {
  static constexpr int TM = 16, TN = 8, NV = 4;
  __device__ static int row(int lane, int v) { return (lane >> 2) + 8 * (v >> 1); }
  __device__ static int col(int lane, int v) { return 2 * (lane & 3) + (v & 1); }
  __device__ static void run(float c[NV], const float* a, int am, int ak,
                             const float* b, int bk, int bn, int K, int lane,
                             int m_left, int n_left) {
    const int g = lane >> 2, q = lane & 3;
    const float* a0 = a + min(g, m_left - 1) * am;
    const float* a1 = a + min(g + 8, m_left - 1) * am;
    const float* b0 = b + min(2 * q, n_left - 1) * bn;
    const float* b1 = b + min(2 * q + 1, n_left - 1) * bn;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float x0 = a0[k * ak], x1 = a1[k * ak];
      const float y0 = b0[k * bk], y1 = b1[k * bk];
      c[0] = fmaf(x0, y0, c[0]);
      c[1] = fmaf(x0, y1, c[1]);
      c[2] = fmaf(x1, y0, c[2]);
      c[3] = fmaf(x1, y1, c[3]);
    }
  }
};

// The tiles of an M x N product, dealt to the block's warps; the tile
// numbering starts at warp `job0` so that two products issued back to back
// share the warps evenly.  Returns job0 plus the number of tiles.  With ACC
// the product is added to C (each element by one lane, in a fixed order).
template <typename T, bool ACC>
__device__ int gemm(T* c, int cm, int cn, const T* a, int am, int ak,
                    const T* b, int bk, int bn, int M, int N, int K, int job0,
                    int warp, int lane) {
  using TT = Tile<T>;
  const int tn = (N + TT::TN - 1) / TT::TN;
  const int jobs = ((M + TT::TM - 1) / TT::TM) * tn;
  for (int j = (warp - job0 % kWarps + kWarps) % kWarps; j < jobs; j += kWarps) {
    const int m0 = (j / tn) * TT::TM, n0 = (j % tn) * TT::TN;
    T acc[TT::NV];
#pragma unroll
    for (int v = 0; v < TT::NV; ++v) {
      const int m = m0 + TT::row(lane, v), n = n0 + TT::col(lane, v);
      acc[v] = (ACC && m < M && n < N) ? c[m * cm + n * cn] : T(0);
    }
    TT::run(acc, a + m0 * am, am, ak, b + n0 * bn, bk, bn, K, lane, M - m0,
            N - n0);
#pragma unroll
    for (int v = 0; v < TT::NV; ++v) {
      const int m = m0 + TT::row(lane, v), n = n0 + TT::col(lane, v);
      if (m < M && n < N) c[m * cm + n * cn] = acc[v];
    }
  }
  return job0 + jobs;
}

// Stream-grouped tiles: all S streams of 8 points at once, C_s = A_s·B for
// the point rows A_s(g, k) = a[s·ss + g·am + k] of stream s, with
// B(k, n) = b[k·bk + n·bn].  The S products are independent chains that
// share B's operand, and a lane ends up holding every stream of its points,
// so the per-neuron Taylor rules run in registers right after the product.
// Lane t holds point t/4 (a lane past the tile's last point reads that
// point's rows, and its results are not used) and the columns col(t, v);
// streams outside [s_lo, s_hi) are skipped (their C stays as given; in
// float64 a skipped stream that shares its DMMA with a stream in the range
// gets its rows' product added, so its rows must hold zeros, as the head's
// dead cotangent streams do).
template <typename T>
struct StreamTile;

// float64: 8 points x 8 columns.  Streams s and s+1 of the 8 points are
// the 16 rows of one m16n8k8 DMMA, whose rate on the H100 is twice
// m8n8k4's (63.8 against 32.8 TFLOP/s, operands in registers); an odd S's
// last stream takes two m8n8k4.  So 8 of K cost S/2 m16n8k8 where one
// m8n8k4 per stream and k-step would cost 2S, in the same k order.  K is a
// multiple of 8.
template <>
struct StreamTile<double> {
  static constexpr int CT = 8, NV = 2;
  __device__ static int col(int lane, int v) { return 2 * (lane & 3) + v; }
  template <int S>
  __device__ static void run(double (&c)[S][NV], const double* a, int am, int ss,
                             const double* b, int bk, int bn, int K, int lane,
                             int p_left, int s_lo, int s_hi, int) {
    const int g = lane >> 2, q = lane & 3;
    const double* ap = a + min(g, p_left - 1) * am + q;
    const double* bp = b + q * bk + g * bn;
    // (rolled: unrolled, the operands of two steps spill the backward
    // residual kernels past their 128 registers)
#pragma unroll 1
    for (int k = 0; k < K; k += 8) {
      const double b0 = bp[k * bk], b1 = bp[(k + 4) * bk];
#pragma unroll
      for (int s = 0; s < S; s += 2) {
        const int t = s + 1 < S ? s + 1 : s;
        if (t < s_lo || s >= s_hi) continue;
        const double* as = ap + s * ss + k;
        const double* at = ap + t * ss + k;
        if (t != s) {
          dmma_16x8x8(c[s][0], c[s][1], c[t][0], c[t][1], as[0], at[0], as[4],
                      at[4], b0, b1);
        } else {
          dmma_8x8x4(c[s][0], c[s][1], as[0], b0, c[s][0], c[s][1]);
          dmma_8x8x4(c[s][0], c[s][1], as[4], b1, c[s][0], c[s][1]);
        }
      }
    }
  }
};

// float32: 8 points x 16 columns, IEEE FFMA, 4 columns per lane; columns
// past N read a clamped column and are not used.
template <>
struct StreamTile<float> {
  static constexpr int CT = 16, NV = 4;
  __device__ static int col(int lane, int v) { return 4 * (lane & 3) + v; }
  template <int S>
  __device__ static void run(float (&c)[S][NV], const float* a, int am, int ss,
                             const float* b, int bk, int bn, int K, int lane,
                             int p_left, int s_lo, int s_hi, int n_left) {
    const float* ap = a + min(lane >> 2, p_left - 1) * am;
    const float* bc[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) bc[j] = b + min(col(lane, j), n_left - 1) * bn;
    for (int k = 0; k < K; ++k) {
      float bv[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) bv[j] = bc[j][k * bk];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s < s_lo || s >= s_hi) continue;
        const float av = ap[s * ss + k];
#pragma unroll
        for (int j = 0; j < NV; ++j) c[s][j] = fmaf(av, bv[j], c[s][j]);
      }
    }
  }
};

// The tanh-Taylor epilogue of one hidden neuron of one point: from the
// pre-activation streams z (bias included on z[0]) write the output streams
// (stream s at out[s·ss]) and, with keep_aux, (tanh', z_g, z_h) to aux, the
// values the backward rule needs.
// Spatial column j is input column j + OFF (OFF = 1 when column 0 is time).
template <typename T, int D>
__device__ __forceinline__ void tanh_epilogue(const T* z, bool first, T* out,
                                              T* aux, int ss, bool keep_aux) {
  constexpr int OFF = (D == 3) ? 1 : 0;
  const T v = tanh_t(z[0]);
  const T tp = T(1) - v * v;
  const T a = T(-2) * v * tp;
  out[0] = v;
  if (keep_aux) {
    aux[0] = tp;
#pragma unroll
    for (int s = 1; s < 1 + D + kNh; ++s) aux[s * ss] = z[s];
  }
#pragma unroll
  for (int k = 0; k < D; ++k) out[(1 + k) * ss] = tp * z[1 + k];
#pragma unroll
  for (int j = 0; j < kNh; ++j) {
    const T zg = z[1 + j + OFF];
    T h = a * (zg * zg);
    if (!first) h += tp * z[1 + D + j];
    out[(1 + D + j) * ss] = h;
  }
}

// The backward tanh-Taylor rule of one hidden neuron of one point: from the
// cotangents ds of its output streams, its aux values (stream s at
// aux[s·ssa]) and its value v, write the cotangents of its pre-activation
// streams to dz[s·ssz].  `first` marks layer 0 (no Hessian input stream).
template <typename T, int D>
__device__ __forceinline__ void cotangent_rule(const T* ds, const T* aux,
                                               int ssa, T v, bool first, T* dz,
                                               int ssz) {
  constexpr int OFF = (D == 3) ? 1 : 0;
  const T tp = aux[0];
  T zg[D];
#pragma unroll
  for (int k = 0; k < D; ++k) zg[k] = aux[(1 + k) * ssa];
  const T a = T(-2) * v * tp;
  const T b2 = T(-2) * tp * (tp - T(2) * v * v);
  T dzv = ds[0] * tp;
#pragma unroll
  for (int k = 0; k < D; ++k) dzv += ds[1 + k] * (a * zg[k]);
#pragma unroll
  for (int j = 0; j < kNh; ++j) {
    const T zgp = zg[j + OFF];
    T hterm = b2 * (zgp * zgp);
    if (!first) hterm += a * aux[(1 + D + j) * ssa];
    dzv += ds[1 + D + j] * hterm;
  }
  dz[0] = dzv;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    T part_g = ds[1 + k] * tp;
#pragma unroll
    for (int j = 0; j < kNh; ++j)
      if (j + OFF == k) part_g += ds[1 + D + j] * (T(2) * a * zg[k]);
    dz[(1 + k) * ssz] = part_g;
  }
#pragma unroll
  for (int j = 0; j < kNh; ++j) dz[(1 + D + j) * ssz] = ds[1 + D + j] * tp;
}

// Hidden layer l >= 1 forward: per warp job (8 points x CT neurons) the
// products Z_s = A_s·W of every stream, the bias on the value stream, then
// the epilogue into act[l] (and aux[l]).  Returns the number of jobs.
template <typename T, int D>
__device__ int forward_layer(T* sm, const Layout& ly, int l, int P, bool keep_aux,
                             int warp, int lane) {
  using ST = StreamTile<T>;
  constexpr int S = 1 + D + kNh;
  const int wi = ly.wp[l], wo = ly.wp[l + 1];
  const int ldi = ly.ld[l], ldo = ly.ld[l + 1];
  const T* A = sm + ly.act[l - 1];
  const T* W = sm + ly.w_off[l];
  const T* bb = sm + ly.b_off[l];
  T* act = sm + ly.act[l];
  T* aux = sm + ly.aux[l];
  const int nc = (wo + ST::CT - 1) / ST::CT;
  const int jobs = ((P + 7) / 8) * nc;
  for (int j = warp; j < jobs; j += kWarps) {
    const int p0 = (j / nc) * 8, c0 = (j % nc) * ST::CT;
    T c[S][ST::NV];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int v = 0; v < ST::NV; ++v) c[s][v] = T(0);
    ST::template run<S>(c, A + p0 * ldi, ldi, P * ldi, W + c0, ldo, 1, wi, lane,
                        P - p0, 0, S, wo - c0);
    const int p = p0 + (lane >> 2);
    if (p >= P) continue;
#pragma unroll
    for (int v = 0; v < ST::NV; ++v) {
      const int o = c0 + ST::col(lane, v);
      if (o >= wo) continue;
      T z[S];
#pragma unroll
      for (int s = 0; s < S; ++s) z[s] = c[s][v];
      z[0] += bb[o];
      const int e = p * ldo + o;
      tanh_epilogue<T, D>(z, false, act + e, aux + e, P * ldo, keep_aux);
    }
  }
  return jobs;
}

// Backward through layer l >= 1 into layer l-1: per warp job (8 points x CT
// input neurons) the products dA_s = DZ_s·Wᵀ of the streams in [s_lo, s_hi)
// (the others carry no cotangent), then layer l-1's cotangent rule into
// dz_out.  Returns the number of jobs.
template <typename T, int D>
__device__ int backward_layer(T* sm, const Layout& ly, int l, int P,
                              const T* dz, T* dz_out, int s_lo, int s_hi,
                              int warp, int lane) {
  using ST = StreamTile<T>;
  constexpr int S = 1 + D + kNh;
  const int wi = ly.wp[l], wo = ly.wp[l + 1];
  const int ldi = ly.ld[l], ldo = ly.ld[l + 1], ldm = ly.ldm;
  const T* W = sm + ly.w_off[l];
  const T* aux = sm + ly.aux[l - 1];
  const T* act = sm + ly.act[l - 1];
  const int nc = (wi + ST::CT - 1) / ST::CT;
  const int jobs = ((P + 7) / 8) * nc;
  for (int j = warp; j < jobs; j += kWarps) {
    const int p0 = (j / nc) * 8, c0 = (j % nc) * ST::CT;
    T c[S][ST::NV];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int v = 0; v < ST::NV; ++v) c[s][v] = T(0);
    ST::template run<S>(c, dz + p0 * ldm, ldm, P * ldm, W + c0 * ldo, 1, ldo, wo,
                        lane, P - p0, s_lo, s_hi, wi - c0);
    const int p = p0 + (lane >> 2);
    if (p >= P) continue;
#pragma unroll
    for (int v = 0; v < ST::NV; ++v) {
      const int i = c0 + ST::col(lane, v);
      if (i >= wi) continue;
      T ds[S];
#pragma unroll
      for (int s = 0; s < S; ++s) ds[s] = c[s][v];
      const int ea = p * ldi + i;
      cotangent_rule<T, D>(ds, aux + ea, P * ldi, act[ea], l == 1,
                           dz_out + p * ldm + i, P * ldm);
    }
  }
  return jobs;
}

// Stage `count` elements of a P-point input tile (x rows, then the extra
// column) into shared memory; rows at and past n_eff read nothing and are
// zero.
template <typename T, int D, int XE>
__device__ __forceinline__ void load_tile(T* dst, const T* x, const T* extra,
                                          int tile, int P, int n_eff, int tid) {
  constexpr int XC = D + XE;
  for (int q = tid; q < P * XC; q += kThreads) {
    const int p = q / XC, c = q % XC;
    const int row = tile * P + p;
    const bool ok = row < n_eff;
    const T* src = !ok ? x : (c < D ? x + (size_t)row * D + c : extra + row);
    cp_async<sizeof(T)>(dst + q, src, ok);
  }
}

// The one-pass kernel.  Each block writes its partials (part, n_acc per
// block: [dW_0 rows, db_0, dW_1 rows, db_1, ..., the n_sq squared sums]
// with BWD, else the squared sums alone); the last block to finish sums
// them in block order 0..G-1 into out (the sums as MSEs, ÷ n_mean; with
// with_loss, gbar · mses after them) and resets the ticket.
template <class H, bool BWD>
__global__ void __launch_bounds__(kThreads, 1)
residual_kernel(const typename H::T* __restrict__ x, Weights<typename H::T> wts,
                Net net, typename H::Args args,
                const typename H::T* __restrict__ gbar,
                typename H::T two_over_n, typename H::T n_mean, int n_eff,
                int P, int acc_smem, int with_loss,
                typename H::T* __restrict__ part,
                typename H::T* __restrict__ out, unsigned* __restrict__ ticket) {
  using T = typename H::T;
  constexpr int D = H::D;
  constexpr int S = 1 + D + kNh;
  constexpr int OFF = (D == 3) ? 1 : 0;
  constexpr int DOut = H::kDOut;
  constexpr int NSQ = H::kNsq;
  constexpr int XE = H::kExtra;
  T* sm = reinterpret_cast<T*>(dynamic_smem());
  Layout ly;
  ly.build(net, D, NSQ, XE, P, BWD, acc_smem);
  const int L = net.n_layers;
  const int n_acc = ly.n_acc;
  // the block's accumulators: in shared memory, or in its own partial slice
  T* acc = acc_smem ? sm + ly.acc0 : part + (size_t)blockIdx.x * n_acc;
  const int R = ly.R;
  const int XC = ly.xc;
  const int ldm = ly.ldm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the head products skip the rows of dead head streams when a stream's
  // rows are whole 8-row tiles
  const bool skip = P % 8 == 0;
  const int h_lo = skip ? H::kLiveLo * P : 0;
  const int h_hi = skip ? H::kLiveHi * P : R;

  // weights (zero-padded) by asynchronous copies; accumulators and stream
  // buffers zeroed, so padding rows and columns hold zeros throughout
  for (int l = 0; l < L; ++l) {
    const int wi = net.widths[l], wo = net.widths[l + 1];
    const int rows = ly.wp[l], ldw = ly.ld[l + 1];
    T* W = sm + ly.w_off[l];
    for (int q = tid; q < rows * ldw; q += kThreads) {
      const int i = q / ldw, o = q % ldw;
      if (i < wi && o < wo)
        cp_async<sizeof(T)>(W + q, wts.w[l] + i * wo + o, true);
      else
        W[q] = T(0);
    }
    for (int q = tid; q < ly.wp[l + 1]; q += kThreads) {
      if (q < wo)
        cp_async<sizeof(T)>(sm + ly.b_off[l] + q, wts.b[l] + q, true);
      else
        sm[ly.b_off[l] + q] = T(0);
    }
  }
  // (the input buffers are left alone: the first tile's copy may land first)
  const int xb_end = ly.xb[1] + (ly.xb[1] - ly.xb[0]);
  for (int q = ly.acc0 + tid; q < ly.total; q += kThreads)
    if (q < ly.xb[0] || q >= xb_end) sm[q] = T(0);
  if (!acc_smem)
    for (int q = tid; q < n_acc; q += kThreads) acc[q] = T(0);
  cp_async_commit();
  T g[NSQ];
#pragma unroll
  for (int k = 0; k < NSQ; ++k) g[k] = BWD ? gbar[k] : T(0);
  const T* extra = H::extra(args);

  const int n_tiles = (n_eff + P - 1) / P;
  if ((int)blockIdx.x < n_tiles)
    load_tile<T, D, XE>(sm + ly.xb[0], x, extra, blockIdx.x, P, n_eff, tid);
  cp_async_commit();
  int buf = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    // prefetch the block's next tile, then wait for this one (and the
    // weights)
    const int next = tile + gridDim.x;
    if (next < n_tiles)
      load_tile<T, D, XE>(sm + ly.xb[buf ^ 1], x, extra, next, P, n_eff, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int n_act = min(P, n_eff - tile * P);
    const T* xt = sm + ly.xb[buf];

    // layer 0 in closed form: the gradient input streams are basis vectors
    // (z_g = W0[k, :]) and the Hessian input streams zero
    {
      const int wo = ly.wp[1], ldo = ly.ld[1];
      const T* W = sm + ly.w_off[0];
      const T* bb = sm + ly.b_off[0];
      const bool hidden = L > 1;
      T* dst = sm + (hidden ? ly.act[0] : ly.head);
      for (int q = tid; q < P * wo; q += kThreads) {
        const int p = q / wo, o = q % wo;
        T z[S];
        T zv = T(0);
        for (int i = 0; i < D; ++i) zv += xt[p * XC + i] * W[i * ldo + o];
        z[0] = zv + bb[o];
#pragma unroll
        for (int k = 0; k < D; ++k) z[1 + k] = W[k * ldo + o];
#pragma unroll
        for (int j = 0; j < kNh; ++j) z[1 + D + j] = T(0);
        const int e = p * ldo + o, ss = P * ldo;
        if (hidden) {
          tanh_epilogue<T, D>(z, true, dst + e, sm + ly.aux[0] + e, ss, BWD);
        } else {
#pragma unroll
          for (int s = 0; s < S; ++s) dst[e + s * ss] = z[s];
        }
      }
      __syncthreads();
    }

    // hidden layers 1..L-2: products and epilogue in one phase each
    for (int l = 1; l + 1 < L; ++l) {
      forward_layer<T, D>(sm, ly, l, P, BWD, warp, lane);
      __syncthreads();
    }
    // the head: Z = A·W over the rows of live streams; meanwhile the head
    // cotangent rows are cleared for the residual pass
    T* dzh = sm + ly.cz[(L - 1) & 1];
    if (L > 1) {
      const int wi = ly.wp[L - 1], wo = ly.wp[L];
      const int ldi = ly.ld[L - 1], ldo = ly.ld[L];
      gemm<T, false>(sm + ly.head + h_lo * ldo, ldo, 1,
                     sm + ly.act[L - 2] + h_lo * ldi, ldi, 1,
                     sm + ly.w_off[L - 1], ldo, 1, h_hi - h_lo, wo, wi, 0, warp,
                     lane);
    }
    if (BWD) {
      for (int q = tid; q < S * P * ly.wp[L]; q += kThreads)
        dzh[(q / ly.wp[L]) * ldm + q % ly.wp[L]] = T(0);
    }
    __syncthreads();

    // the residual rows of each point, their squares and, with BWD, the
    // head-stream cotangents (none for rows at and past n_eff)
    {
      const int ldh = ly.ld[L], ssh = P * ldh;
      const T* bh = sm + ly.b_off[L - 1];
      for (int p = tid; p < P; p += kThreads) {
        T* hd = sm + ly.head + p * ldh;
        if (L > 1 && H::kLiveLo == 0) {
#pragma unroll
          for (int o = 0; o < DOut; ++o) hd[o] += bh[o];
        }
        const bool ok = p < n_act;
        T r[NSQ];
        if (ok) {
          H::rows(hd, ssh, xt + p * XC, args, r);
        } else {
#pragma unroll
          for (int k = 0; k < NSQ; ++k) r[k] = T(0);
        }
#pragma unroll
        for (int k = 0; k < NSQ; ++k) sm[ly.sq + p * NSQ + k] = r[k] * r[k];
        if (BWD && ok)
          H::cotangents(hd, ssh, args, r, g, two_over_n, dzh + p * ldm, P * ldm);
      }
      __syncthreads();
      if (tid < NSQ) {
        T t = T(0);
        for (int p = 0; p < n_act; ++p) t += sm[ly.sq + p * NSQ + tid];
        acc[n_acc - NSQ + tid] += t;
      }
    }

    // backward, head first: per layer one phase with db_l, dW_l += Aᵀ·DZ_l
    // and (l >= 1) the stream-grouped dA·rule into layer l-1's cotangents
    if (BWD) {
      for (int l = L - 1; l >= 0; --l) {
        const int ri = net.widths[l], ro = net.widths[l + 1];  // unpadded
        const bool head = l == L - 1;
        const T* dz = sm + ly.cz[l & 1];
        T* dW = acc + ly.g_off[l];  // ri x ro, then db_l
        T* db = dW + ri * ro;
        // db: the value-stream rows (the head's only when it is live), by
        // the block's last threads
        if (!head || H::kLiveLo == 0) {
          for (int o = kThreads - 1 - tid; o < ro; o += kThreads) {
            T t = T(0);
            for (int p = 0; p < P; ++p) t += dz[p * ldm + o];
            db[o] += t;
          }
        }
        if (l == 0) {
          // dW_0 in closed form: x · dz over the value stream plus the
          // gradient stream of each input column
          for (int q = tid; q < D * ro; q += kThreads) {
            const int i = q / ro, o = q % ro;
            T t = T(0);
            for (int p = 0; p < P; ++p)
              t += xt[p * XC + i] * dz[p * ldm + o] + dz[((1 + i) * P + p) * ldm + o];
            dW[i * ro + o] += t;
          }
        } else {
          const int lo = head ? h_lo : 0, hi = head ? h_hi : R;
          const int jobs = backward_layer<T, D>(
              sm, ly, l, P, dz, sm + ly.cz[(l - 1) & 1],
              head ? H::kLiveLo : 0, head ? H::kLiveHi : S, warp, lane);
          // dW_l += Aᵀ·DZ over the tile's rows (stored unpadded)
          const int ldi = ly.ld[l];
          gemm<T, true>(dW, ro, 1, sm + ly.act[l - 1] + lo * ldi, 1, ldi,
                        dz + lo * ldm, ldm, 1, ri, ro, hi - lo, jobs, warp, lane);
        }
        __syncthreads();
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // the block's partials, in the order of `out`
  if (acc_smem)
    for (int q = tid; q < n_acc; q += kThreads)
      part[(size_t)blockIdx.x * n_acc + q] = acc[q];
  __threadfence();
  __syncthreads();
  unsigned t = 0;
  if (tid == 0) t = atomicAdd(ticket, 1u);
  if (!__syncthreads_or(tid == 0 && t == gridDim.x - 1)) return;

  // the last block: the fixed-order sum over blocks
  __threadfence();
  const int G = gridDim.x;
  for (int q = tid; q < n_acc; q += kThreads) {
    T s = T(0);
    for (int b = 0; b < G; ++b) s += __ldcg(part + (size_t)b * n_acc + q);
    if (q >= n_acc - NSQ) s = s / n_mean;
    out[q] = s;
  }
  __syncthreads();
  if (tid == 0) {
    if (with_loss) {
      const T* m = out + n_acc - NSQ;
      T loss = gbar[0] * m[0];
      for (int k = 1; k < NSQ; ++k) loss += gbar[k] * m[k];
      out[n_acc] = loss;
    }
    *ticket = 0u;
  }
}

bool make_net(const int* widths, int n_layers, int d_in, int d_out, Net* net) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  if (widths[0] != d_in || widths[n_layers] != d_out) return false;
  net->n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] < 1 || (l > 0 && widths[l] > kMaxWidth)) return false;
    net->widths[l] = widths[l];
  }
  return true;
}

// Let an instance use all of a block's shared memory: once per instance and
// device, not per launch.
int allow_smem(void* kernel) {
  static void* done[64][16];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  for (int i = 0; i < 16 && dev < 64; ++i) {
    if (done[dev][i] == kernel) return 0;
    if (done[dev][i] == nullptr) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemLimit);
      if (err != cudaSuccess) return int(err);
      done[dev][i] = kernel;
      return 0;
    }
  }
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmemLimit));
}

// Whether a P-point backward block fits the shared memory, with the
// accumulators there (acc_smem) or in the partials.
bool tile_fits(const Net& net, int d_in, int n_sq, int x_extra, size_t elem,
               int P, bool acc_smem) {
  Layout ly;
  ly.build(net, d_in, n_sq, x_extra, P, true, acc_smem);
  return size_t(ly.total) * elem <= size_t(kSmemLimit);
}

// Points per tile for one call shape (mirrored by plan_points in
// tpinn_torch/kernels/mlp_bundle.py).  Of the candidates whose backward
// block fits the shared memory (with the accumulators in the partials if
// need be), the largest whose tile count reaches the SM count or that is at
// most 8: a small batch keeps 8-point tiles, whose products still give
// every warp a tile, and a large one takes the largest tile, which
// amortises a tile's barriers over the most points.  0 when nothing fits.
// A plan keeps its accumulators in shared memory exactly when
// tile_fits(..., P, true).
int plan_points(const Net& net, int d_in, int n_sq, int x_extra, size_t elem,
                int n_eff, int sms) {
  for (int P : kTileCands) {
    if (!tile_fits(net, d_in, n_sq, x_extra, elem, P, false)) continue;
    if (P <= 8 || (n_eff + P - 1) / P >= sms) return P;
  }
  return 0;
}

// Launch plan for one call shape: points per tile (P), grid size (G: one
// block per tile, at most the resident blocks), dynamic shared memory bytes
// and the accumulator count.  The forward takes
// the backward's P and G (with its own, smaller, shared memory), so it walks
// the tiles in the same blocks and sums the squared residuals in the same
// order: its MSEs equal the backward's bit for bit.  Returns 0, or a
// cudaError_t / -1 when the net does not fit.
int plan_blocks(const Net& net, int d_in, int n_sq, int x_extra, bool bwd,
                size_t elem, void* kernel_bwd, int n_eff, int* P_out,
                int* G_out, int* smem_out, int* n_acc_out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  const int P = plan_points(net, d_in, n_sq, x_extra, elem, n_eff, sms);
  if (P == 0) return -1;
  const bool acc_smem = tile_fits(net, d_in, n_sq, x_extra, elem, P, true);
  Layout ly;
  ly.build(net, d_in, n_sq, x_extra, P, true, acc_smem);
  int rc = allow_smem(kernel_bwd);
  if (rc != 0) return rc;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel_bwd, kThreads, size_t(ly.total) * elem);
  if (err != cudaSuccess) return int(err);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  const int n_tiles = (n_eff + P - 1) / P;
  int G = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  if (G < 1) G = 1;
  ly.build(net, d_in, n_sq, x_extra, P, bwd, acc_smem);
  *P_out = P;
  *G_out = G;
  *smem_out = int(size_t(ly.total) * elem);
  *n_acc_out = ly.n_acc;
  return 0;
}

// Launch the one-pass kernel on `stream`; returns cudaGetLastError() after
// the launch.  out holds n_acc (+1 with_loss) elements, part G * n_acc;
// ticket is an unsigned that is zero between launches.
template <class H, bool BWD>
int launch_residual(const void* x, const void* const* w, const void* const* b,
                    const Net& net, int n_eff, const typename H::Args& args,
                    const void* gbar, double two_over_n, double n_mean,
                    int with_loss, int P, int G, int smem, void* part, void* out,
                    void* ticket, void* stream) {
  using T = typename H::T;
  Weights<T> wts;
  for (int l = 0; l < kMaxLayers; ++l) {
    wts.w[l] = l < net.n_layers ? static_cast<const T*>(w[l]) : nullptr;
    wts.b[l] = l < net.n_layers ? static_cast<const T*>(b[l]) : nullptr;
  }
  const bool acc_smem =
      tile_fits(net, H::D, H::kNsq, H::kExtra, sizeof(T), P, true);
  Layout ly;
  ly.build(net, H::D, H::kNsq, H::kExtra, P, BWD, acc_smem);
  if (size_t(ly.total) * sizeof(T) != size_t(smem)) return int(cudaErrorInvalidValue);
  void* k = reinterpret_cast<void*>(&residual_kernel<H, BWD>);
  const int rc = allow_smem(k);
  if (rc != 0) return rc;
  residual_kernel<H, BWD><<<dim3(G), dim3(kThreads), smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), wts, net, args, static_cast<const T*>(gbar),
      T(two_over_n), T(n_mean), n_eff, P, int(acc_smem), with_loss,
      static_cast<T*>(part),
      static_cast<T*>(out), static_cast<unsigned*>(ticket));
  return int(cudaGetLastError());
}

}  // namespace
