// Shared device machinery of the fused PDE-residual kernels (sm_90a).
//
// Included by ns_residual.cu (Navier–Stokes head) and poisson_residual.cu
// (Poisson head); each source is its own translation unit and shared library.
// What is here is independent of the PDE:
//   * the shared-memory layout of one block (weights, accumulators, per-point
//     Taylor streams and their cotangents);
//   * the forward Taylor-stream propagation of one point through the tanh MLP
//     (value, one gradient stream per input column, one Hessian-diagonal
//     stream per spatial column), one warp per point;
//   * the one-pass kernel `residual_kernel<H, BWD>`: a grid-stride walk over
//     tiles of P points; per point the forward streams, the residuals and
//     their squares; with BWD the output-stream cotangents and the reverse
//     walk over the layers for every dW/db, contracted over the tile's points
//     into per-block accumulators (no atomics);
//   * the fixed-order reduction of the block partials (`reduce_partials`),
//     so two calls at the same parameters agree bit for bit;
//   * the launch plan and the launch itself.
// The PDE enters through a head policy H (see NSHead / PoissonHead), which
// gives the element type T, the input width D, the head width kDOut, the
// number of squared-residual sums kNsq, the per-point residual rows, the
// head-stream cotangents, and which head streams can carry a nonzero
// cotangent (`head_live`): the others are structural zeros whose head-layer
// contractions are skipped.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxLayers = 8;  // Dense layers, head included
constexpr int kMaxWidth = 64;  // any layer's output width
constexpr int kNpl = kMaxWidth / 32;  // neurons per lane
constexpr int kNh = 2;  // Hessian-diagonal streams: the two spatial columns
constexpr int kReduceThreads = 1024;

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

// Shared-memory layout, in elements of T.  Identical on host and device (and
// mirrored by smem_elems in tpinn_torch/kernels/mlp_bundle.py).
struct Layout {
  int w_off[kMaxLayers];   // weights, row stride widths[l+1] + 1
  int b_off[kMaxLayers];
  int g_off[kMaxLayers];   // per layer (in+1)*out accumulators: dW rows, then db
  int sq_acc;              // the n_sq squared-residual sums
  int n_acc;               // accumulator count (grads + n_sq)
  int acc0;                // start of the accumulators
  int pt0;                 // start of the per-point regions
  // per point (stride pt), relative to the point's region:
  int st_off[kMaxLayers];  // hidden layer l: aux block (S*w), then out block (S*w)
  int hd_off;              // head output streams (S*d_out)
  int dz_off;              // stream cotangents (S*maxw)
  int sq_off;              // the point's squared residuals
  int pt;                  // point stride
  int maxw;
  int total;               // elements for P points

  __host__ __device__ void build(const Net& net, int d_in, int d_out, int n_sq,
                                 int P, bool bwd) {
    const int S = 1 + d_in + kNh;
    const int L = net.n_layers;
    int off = 0;
    maxw = 0;
    for (int l = 0; l < L; ++l) {
      const int wi = net.widths[l], wo = net.widths[l + 1];
      w_off[l] = off;
      off += wi * (wo + 1);
      b_off[l] = off;
      off += wo;
      if (wo > maxw) maxw = wo;
    }
    acc0 = off;
    n_acc = 0;
    for (int l = 0; l < L; ++l) {
      g_off[l] = acc0 + n_acc;
      if (bwd) n_acc += (net.widths[l] + 1) * net.widths[l + 1];
    }
    sq_acc = acc0 + n_acc;
    n_acc += n_sq;
    pt0 = acc0 + n_acc;
    int po = d_in;
    for (int l = 0; l + 1 < L; ++l) {
      st_off[l] = po;
      po += 2 * S * net.widths[l + 1];
    }
    hd_off = po;
    po += S * d_out;
    dz_off = po;
    po += bwd ? S * maxw : 0;
    sq_off = po;
    po += n_sq;
    pt = po + (po & 1);  // keep each point's region 16-byte aligned for double
    total = pt0 + P * pt;
  }
};

// Propagate one point's Taylor streams through every layer (one warp).
// Spatial column j is input column j + OFF (OFF = 1 when column 0 is time).
template <typename T, int D, int DOut>
__device__ void forward_point(T* sm, const Layout& ly, const Net& net, T* pt,
                              int lane, bool keep_aux) {
  constexpr int S = 1 + D + kNh;
  constexpr int OFF = (D == 3) ? 1 : 0;
  const int L = net.n_layers;
  for (int l = 0; l < L; ++l) {
    const int win = net.widths[l], wout = net.widths[l + 1];
    const int ldw = wout + 1;
    const T* W = sm + ly.w_off[l];
    const T* bb = sm + ly.b_off[l];
    const bool hidden = l + 1 < L;
    const T* in = (l == 0) ? pt : pt + ly.st_off[l - 1] + S * win;
    T* aux = hidden ? pt + ly.st_off[l] : nullptr;
    T* out = hidden ? pt + ly.st_off[l] + S * wout : pt + ly.hd_off;
#pragma unroll
    for (int r = 0; r < kNpl; ++r) {
      const int o = lane + 32 * r;
      if (o >= wout) continue;
      T z[S];
      if (l == 0) {
        // gradient input streams are basis vectors, Hessian streams zero
        T acc = T(0);
        for (int i = 0; i < D; ++i) acc += in[i] * W[i * ldw + o];
        z[0] = acc + bb[o];
#pragma unroll
        for (int k = 0; k < D; ++k) z[1 + k] = W[k * ldw + o];
#pragma unroll
        for (int j = 0; j < kNh; ++j) z[1 + D + j] = T(0);
      } else {
#pragma unroll
        for (int s = 0; s < S; ++s) z[s] = T(0);
        for (int i = 0; i < win; ++i) {
          const T w = W[i * ldw + o];
#pragma unroll
          for (int s = 0; s < S; ++s) z[s] += in[s * win + i] * w;
        }
        z[0] += bb[o];
      }
      if (hidden) {
        const T v = tanh_t(z[0]);
        const T tp = T(1) - v * v;
        const T a = T(-2) * v * tp;
        out[o] = v;
        if (keep_aux) aux[o] = tp;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          out[(1 + k) * wout + o] = tp * z[1 + k];
          if (keep_aux) aux[(1 + k) * wout + o] = z[1 + k];
        }
#pragma unroll
        for (int j = 0; j < kNh; ++j) {
          const T zg = z[1 + j + OFF];
          T h = a * (zg * zg);
          if (l > 0) h += tp * z[1 + D + j];
          out[(1 + D + j) * wout + o] = h;
          if (keep_aux) aux[(1 + D + j) * wout + o] = z[1 + D + j];
        }
      } else {
#pragma unroll
        for (int s = 0; s < S; ++s) out[s * DOut + o] = z[s];
      }
    }
    __syncwarp();
  }
}

// The one-pass kernel.  part receives, per block, the n_acc accumulators:
// [dW_0 rows, db_0, dW_1 rows, db_1, ..., the n_sq squared sums] (BWD), or
// the squared sums alone (forward).
template <class H, bool BWD>
__global__ void __launch_bounds__(256)
residual_kernel(const typename H::T* __restrict__ x,
                Weights<typename H::T> wts, Net net, typename H::Args args,
                const typename H::T* __restrict__ gbar,
                typename H::T two_over_n, int n_eff, int P,
                typename H::T* __restrict__ part) {
  using T = typename H::T;
  constexpr int D = H::D;
  constexpr int S = 1 + D + kNh;
  constexpr int DOut = H::kDOut;
  constexpr int NSQ = H::kNsq;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Layout ly;
  ly.build(net, D, DOut, NSQ, P, BWD);
  const int L = net.n_layers;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int l = 0; l < L; ++l) {
    const int wi = net.widths[l], wo = net.widths[l + 1];
    for (int q = tid; q < wi * wo; q += blockDim.x)
      sm[ly.w_off[l] + (q / wo) * (wo + 1) + q % wo] = wts.w[l][q];
    for (int q = tid; q < wo; q += blockDim.x) sm[ly.b_off[l] + q] = wts.b[l][q];
  }
  for (int q = tid; q < ly.n_acc; q += blockDim.x) sm[ly.acc0 + q] = T(0);
  T g[NSQ];
#pragma unroll
  for (int k = 0; k < NSQ; ++k) g[k] = BWD ? gbar[k] : T(0);
  __syncthreads();

  const int n_tiles = (n_eff + P - 1) / P;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row = tile * P + warp;
    const bool active = row < n_eff;
    const int n_act = min(P, n_eff - tile * P);
    T* pt = sm + ly.pt0 + warp * ly.pt;
    T ds[S][kNpl];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int r = 0; r < kNpl; ++r) ds[s][r] = T(0);

    if (active) {
      if (lane < D) pt[lane] = x[(size_t)row * D + lane];
      __syncwarp();
      forward_point<T, D, DOut>(sm, ly, net, pt, lane, BWD);
      const T* hd = pt + ly.hd_off;
      T r[NSQ];
      H::rows(hd, args, row, r);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NSQ; ++k) pt[ly.sq_off + k] = r[k] * r[k];
      }
      // output-stream cotangents of the residual MSEs, lane o for output o
      if (BWD && lane < DOut) H::cotangents(hd, args, r, g, two_over_n, lane, ds);
    }

    if (!BWD) {
      __syncthreads();
      if (tid < NSQ) {
        T t = T(0);
        for (int p = 0; p < n_act; ++p) t += sm[ly.pt0 + p * ly.pt + ly.sq_off + tid];
        sm[ly.sq_acc + tid] += t;
      }
      __syncthreads();
      continue;
    }

    for (int l = L - 1; l >= 0; --l) {
      const int win = net.widths[l], wout = net.widths[l + 1];
      const bool hidden = l + 1 < L;
      T* dzs = pt + ly.dz_off;
      if (active) {
        const T* aux = hidden ? pt + ly.st_off[l] : nullptr;
        const T* outs = hidden ? pt + ly.st_off[l] + S * wout : nullptr;
#pragma unroll
        for (int r = 0; r < kNpl; ++r) {
          const int o = lane + 32 * r;
          if (o >= wout) continue;
          T dz[S];
          if (!hidden) {
#pragma unroll
            for (int s = 0; s < S; ++s) dz[s] = ds[s][r];
          } else {
            const T tp = aux[o];
            const T v = outs[o];
            constexpr int OFF = (D == 3) ? 1 : 0;
            T zg[D];
#pragma unroll
            for (int k = 0; k < D; ++k) zg[k] = aux[(1 + k) * wout + o];
            const T a = T(-2) * v * tp;
            const T b2 = T(-2) * tp * (tp - T(2) * v * v);
            T dzv = ds[0][r] * tp;
#pragma unroll
            for (int k = 0; k < D; ++k) dzv += ds[1 + k][r] * (a * zg[k]);
#pragma unroll
            for (int j = 0; j < kNh; ++j) {
              const T zgp = zg[j + OFF];
              T hterm = b2 * (zgp * zgp);
              if (l > 0) hterm += a * aux[(1 + D + j) * wout + o];
              dzv += ds[1 + D + j][r] * hterm;
            }
            dz[0] = dzv;
#pragma unroll
            for (int k = 0; k < D; ++k) {
              T part_g = ds[1 + k][r] * tp;
#pragma unroll
              for (int j = 0; j < kNh; ++j)
                if (j + OFF == k) part_g += ds[1 + D + j][r] * (T(2) * a * zg[k]);
              dz[1 + k] = part_g;
            }
#pragma unroll
            for (int j = 0; j < kNh; ++j) dz[1 + D + j] = ds[1 + D + j][r] * tp;
          }
#pragma unroll
          for (int s = 0; s < S; ++s) dzs[s * ly.maxw + o] = dz[s];
        }
      }
      __syncthreads();

      // dW/db of layer l, contracted over the tile's points per (i, o) pair;
      // row `win` of the block is the bias.  At the head, streams whose
      // cotangent is a structural zero are skipped.
      const int npairs = (win + 1) * wout;
      T* acc = sm + ly.g_off[l];
      for (int q = tid; q < npairs; q += blockDim.x) {
        const int i = q / wout, o = q % wout;
        T s_acc = T(0);
        for (int p = 0; p < n_act; ++p) {
          const T* pp = sm + ly.pt0 + p * ly.pt;
          const T* dzp = pp + ly.dz_off;
          if (i == win) {
            if (hidden || H::head_live(0)) s_acc += dzp[o];
          } else if (l == 0) {
            s_acc += pp[i] * dzp[o] + dzp[(1 + i) * ly.maxw + o];
          } else {
            const T* inp = pp + ly.st_off[l - 1] + S * win;
            T t = T(0);
#pragma unroll
            for (int s = 0; s < S; ++s)
              if (hidden || H::head_live(s)) t += inp[s * win + i] * dzp[s * ly.maxw + o];
            s_acc += t;
          }
        }
        acc[q] += s_acc;
      }
      if (l == L - 1 && tid < NSQ) {
        T t = T(0);
        for (int p = 0; p < n_act; ++p) t += sm[ly.pt0 + p * ly.pt + ly.sq_off + tid];
        sm[ly.sq_acc + tid] += t;
      }
      __syncthreads();

      if (active && l > 0) {
        // cotangents of layer l's input streams: ds = W · dz per stream
        const T* W = sm + ly.w_off[l];
        const int ldw = wout + 1;
#pragma unroll
        for (int r = 0; r < kNpl; ++r) {
          const int i = lane + 32 * r;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            T t = T(0);
            if (i < win && (hidden || H::head_live(s)))
              for (int o = 0; o < wout; ++o) t += dzs[s * ly.maxw + o] * W[i * ldw + o];
            ds[s][r] = t;
          }
        }
        __syncwarp();
      }
    }
  }

  for (int q = tid; q < ly.n_acc; q += blockDim.x)
    part[(size_t)blockIdx.x * ly.n_acc + q] = sm[ly.acc0 + q];
}

// Sum the per-block partials in block order; the last n_sq entries are the
// squared-residual sums, returned as MSEs (÷ n_mean).  With `w` set, also the
// weighted loss w · mses after them.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const T* __restrict__ part, int G, int n_acc, int n_sq,
                const T* __restrict__ w, T n_mean, T* __restrict__ out) {
  for (int q = threadIdx.x; q < n_acc; q += blockDim.x) {
    T s = T(0);
    for (int b = 0; b < G; ++b) s += part[(size_t)b * n_acc + q];
    if (q >= n_acc - n_sq) s = s / n_mean;
    out[q] = s;
  }
  if (w != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const T* m = out + n_acc - n_sq;
      T loss = w[0] * m[0];
      for (int k = 1; k < n_sq; ++k) loss += w[k] * m[k];
      out[n_acc] = loss;
    }
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

// Launch plan for one call shape: points per block (P), grid size (G),
// dynamic shared memory bytes and the accumulator count.  P is the largest
// in {8, 4, 2, 1} whose backward block leaves room for two blocks per SM,
// else the largest that fits one; G is the backward kernel's resident block
// count, at most one block per tile.  The forward takes the same P and G
// (with its own, smaller, shared memory), so it walks the tiles in the same
// blocks and sums the squared residuals in the same order: its MSEs equal
// the backward's bit for bit.  `kernel_bwd` is the backward instantiation.
// Returns 0, or a cudaError_t / -1 when the net does not fit.
int plan_blocks(const Net& net, int d_in, int d_out, int n_sq, bool bwd,
                size_t elem, void* kernel_bwd, int n_eff, int* P_out,
                int* G_out, int* smem_out, int* n_acc_out) {
  const size_t one_block = 227 * 1024, two_blocks = 113 * 1024;
  int P = 0;
  size_t bytes = 0;
  for (int pass = 0; pass < 2 && P == 0; ++pass) {
    for (int cand = 8; cand >= 1; cand /= 2) {
      Layout ly;
      ly.build(net, d_in, d_out, n_sq, cand, true);
      const size_t bb = size_t(ly.total) * elem;
      if (bb <= (pass == 0 ? two_blocks : one_block)) {
        P = cand;
        bytes = bb;
        break;
      }
    }
  }
  if (P == 0) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      kernel_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_bwd, 32 * P, bytes);
  if (err != cudaSuccess) return int(err);
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  const int n_tiles = (n_eff + P - 1) / P;
  int G = per_sm * sms;
  if (n_tiles < G) G = n_tiles;
  if (G < 1) G = 1;
  Layout ly;
  ly.build(net, d_in, d_out, n_sq, P, bwd);
  *P_out = P;
  *G_out = G;
  *smem_out = int(size_t(ly.total) * elem);
  *n_acc_out = ly.n_acc;
  return 0;
}

// Launch the one-pass kernel and the reduction on `stream`; returns
// cudaGetLastError() after the two launches.  out holds n_acc (+1 with_loss)
// elements, part G * n_acc.
template <class H, bool BWD>
int launch_residual(const void* x, const void* const* w, const void* const* b,
                    const Net& net, int n_eff, const typename H::Args& args,
                    const void* gbar, double two_over_n, double n_mean,
                    int with_loss, int P, int G, int smem, void* part, void* out,
                    void* stream) {
  using T = typename H::T;
  Weights<T> wts;
  for (int l = 0; l < kMaxLayers; ++l) {
    wts.w[l] = l < net.n_layers ? static_cast<const T*>(w[l]) : nullptr;
    wts.b[l] = l < net.n_layers ? static_cast<const T*>(b[l]) : nullptr;
  }
  Layout ly;
  ly.build(net, H::D, H::kDOut, H::kNsq, P, BWD);
  if (size_t(ly.total) * sizeof(T) != size_t(smem)) return int(cudaErrorInvalidValue);
  void* k = reinterpret_cast<void*>(&residual_kernel<H, BWD>);
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* gp = static_cast<const T*>(gbar);
  T* pp = static_cast<T*>(part);
  residual_kernel<H, BWD><<<dim3(G), dim3(32 * P), smem, st>>>(
      static_cast<const T*>(x), wts, net, args, gp, T(two_over_n), n_eff, P, pp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  reduce_partials<T><<<1, kReduceThreads, 0, st>>>(
      pp, G, ly.n_acc, H::kNsq, with_loss ? gp : nullptr, T(n_mean),
      static_cast<T*>(out));
  return int(cudaGetLastError());
}

}  // namespace
