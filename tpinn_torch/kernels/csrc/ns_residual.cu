// Fused Navier–Stokes residual kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the two NS-residual Pallas kernels of tpinn/pallas/mlp_bundle.py:
//   * ns_residual_bwd  <- _residual_bwd_kernel (mlp_bundle.py:556), launched by
//     _ns_mse_backward (:984).  One pass per point: recompute the Taylor
//     streams (value, one gradient stream per input column, one
//     Hessian-diagonal stream per spatial column) through the tanh MLP,
//     keeping each layer's input streams and (tanh', z_g, z_h) auxiliaries;
//     form the mass and momentum residuals and their cotangents
//     c = gbar · 2r/n_mean · scale; walk the layers backward for every dW/db;
//     and sum the three squared residuals in the same pass.  Called with the
//     loss weights as gbar it is the one-pass training objective.
//   * ns_residual_fwd  <- _residual_kernel (mlp_bundle.py:473), launched by
//     _ns_mse_forward (:949): the same forward streams and residual rows,
//     only the three squared sums.
//
// What bounds it on this card.  At widths 2-32-32-32-3 the backward does about
// 7e4 floating-point operations per point (2.2e4 forward over 5 streams,
// 4.3e4 for the dW contractions and the back-propagation, the rest
// elementwise) and reads 16 bytes of input per point in float64: it is bound
// by operations, by the fp64 (or fp32) rate.  On the TPU the work went to the
// MXU at 128-wide tiles; here the widths (32) are far below a tensor-core
// tile that pays off for float64, so the design uses plain IEEE FMAs on the
// CUDA cores, the rate that the float64 training path needs.
//
// Design.
//   * One warp per point, lane o owns output neurons o and o + 32 (hidden
//     widths up to 64).  A block holds P warps (a tile of P points) and walks
//     tiles in a grid-stride loop, so the grid is a fixed number of resident
//     blocks and the per-block scratch stays small.
//   * The weights, the tile's stored layer-input streams and auxiliaries, the
//     stream cotangents and the block's running dW/db/sum accumulators live in
//     shared memory; nothing per point goes to device memory.
//   * dW is contracted over the tile's points by a loop per (i, o) thread into
//     the block's accumulator (owned by that thread), not by atomics.  Each
//     block writes its partials once; a second launch sums them over blocks in
//     a fixed order.  Two calls at the same parameters therefore agree bit for
//     bit (the paired-difference accept test of docs/DESIGN.md §3 needs that).
//   * Layer 0's gradient input streams are basis vectors (z_g = W0[k, :]) and
//     its Hessian input streams are zero, so its dW of the gradient streams is
//     a plain sum over points; rows >= n_valid are never processed (their
//     cotangent is zero), and the cotangents use the static n_mean.
//   * The mass row is not multiplied by `scale`; the momentum rows are.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 8;  // Dense layers, head included
constexpr int kMaxWidth = 64;  // any layer's output width
constexpr int kNpl = kMaxWidth / 32;  // neurons per lane
constexpr int kDOut = 3;  // (u, v, p)
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

// Physics constants folded on the host in double, then cast (as the
// reference folds its Python floats before they meet the arrays).
template <typename T>
struct Coef {
  T cnv2;   // conv · nv · nv
  T vnv;    // visc · nv
  T pn;     // pres · npre
  T tnv;    // time · nv
  T scale;  // residual_scale
};

__device__ __forceinline__ float tanh_t(float v) { return tanhf(v); }
__device__ __forceinline__ double tanh_t(double v) { return tanh(v); }

// Shared-memory layout, in elements of T.  Identical on host and device.
struct Layout {
  int w_off[kMaxLayers];   // weights, row stride widths[l+1] + 1
  int b_off[kMaxLayers];
  int g_off[kMaxLayers];   // per layer (in+1)*out accumulators: dW rows, then db
  int sq_acc;              // three squared-residual sums
  int n_acc;               // accumulator count (grads + 3)
  int acc0;                // start of the accumulators
  int pt0;                 // start of the per-point regions
  // per point (stride pt), relative to the point's region:
  int st_off[kMaxLayers];  // hidden layer l: aux block (S*w), then out block (S*w)
  int hd_off;              // head output streams (S*3)
  int dz_off;              // stream cotangents (S*maxw)
  int sq_off;              // the point's three squared residuals
  int pt;                  // point stride
  int maxw;
  int total;               // elements for P points

  __host__ __device__ void build(const Net& net, int d_in, int P, bool bwd) {
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
    n_acc += 3;
    pt0 = acc0 + n_acc;
    int po = d_in;
    for (int l = 0; l + 1 < L; ++l) {
      st_off[l] = po;
      po += 2 * S * net.widths[l + 1];
    }
    hd_off = po;
    po += S * kDOut;
    dz_off = po;
    po += bwd ? S * maxw : 0;
    sq_off = po;
    po += 3;
    pt = po + (po & 1);  // keep each point's region 16-byte aligned for double
    total = pt0 + P * pt;
  }
};

// Propagate one point's Taylor streams through every layer (one warp).
template <typename T, int D>
__device__ void forward_point(T* sm, const Layout& ly, const Net& net, T* pt,
                              int lane, bool keep_aux) {
  constexpr int S = 1 + D + kNh;
  constexpr int OFF = (D == 3) ? 1 : 0;  // spatial column j is input column j+OFF
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
        for (int s = 0; s < S; ++s) out[s * kDOut + o] = z[s];
      }
    }
    __syncwarp();
  }
}

// Residual rows at one point from the head streams: r_mass, r_u, r_v
// (momentum rows scaled, mass row not).
template <typename T, int D>
__device__ __forceinline__ void residual_rows(const T* hd, const Coef<T>& cf,
                                              T& r_mass, T r[2]) {
  constexpr int OFF = (D == 3) ? 1 : 0;
  const T* val = hd;
  const T* gx = hd + (1 + OFF) * kDOut;
  const T* gy = hd + (2 + OFF) * kDOut;
  const T* hx = hd + (1 + D) * kDOut;
  const T* hy = hd + (2 + D) * kDOut;
  r_mass = gx[0] + gy[1];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    T inner = cf.cnv2 * (val[0] * gx[k] + val[1] * gy[k]) -
              cf.vnv * (hx[k] + hy[k]) + cf.pn * (k == 0 ? gx[2] : gy[2]);
    if (D == 3) inner += cf.tnv * hd[kDOut + k];  // ∂t stream = column 0
    r[k] = inner * cf.scale;
  }
}

template <typename T, int D, bool BWD>
__global__ void __launch_bounds__(256)
ns_residual_kernel(const T* __restrict__ x, Weights<T> wts, Net net, Coef<T> cf,
                   const T* __restrict__ gbar, T two_over_n, int n_eff, int P,
                   T* __restrict__ part) {
  constexpr int S = 1 + D + kNh;
  constexpr int OFF = (D == 3) ? 1 : 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  Layout ly;
  ly.build(net, D, P, BWD);
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
  T g0 = T(0), g1 = T(0), g2 = T(0);
  if (BWD) {
    g0 = gbar[0];
    g1 = gbar[1];
    g2 = gbar[2];
  }
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
      forward_point<T, D>(sm, ly, net, pt, lane, BWD);
      const T* hd = pt + ly.hd_off;
      T r_mass, r[2];
      residual_rows<T, D>(hd, cf, r_mass, r);
      if (lane == 0) {
        pt[ly.sq_off + 0] = r_mass * r_mass;
        pt[ly.sq_off + 1] = r[0] * r[0];
        pt[ly.sq_off + 2] = r[1] * r[1];
      }
      if (BWD && lane < kDOut) {
        // output-stream cotangents of the three residual MSEs
        const T c_m = g0 * two_over_n * r_mass;
        const T c0 = g1 * two_over_n * r[0] * cf.scale;
        const T c1 = g2 * two_over_n * r[1] * cf.scale;
        const int o = lane;
        const T* val = hd;
        const T* gx = hd + (1 + OFF) * kDOut;
        const T* gy = hd + (2 + OFF) * kDOut;
        const T zero = T(0);
        const T dval[3] = {c0 * cf.cnv2 * gx[0] + c1 * cf.cnv2 * gx[1],
                           c0 * cf.cnv2 * gy[0] + c1 * cf.cnv2 * gy[1], zero};
        const T dgx[3] = {c0 * cf.cnv2 * val[0] + c_m, c1 * cf.cnv2 * val[0],
                          c0 * cf.pn};
        const T dgy[3] = {c0 * cf.cnv2 * val[1], c1 * cf.cnv2 * val[1] + c_m,
                          c1 * cf.pn};
        const T dh[3] = {-c0 * cf.vnv, -c1 * cf.vnv, zero};
        ds[0][0] = dval[o];
        ds[1 + OFF][0] = dgx[o];
        ds[2 + OFF][0] = dgy[o];
        if (D == 3) {
          const T dt[3] = {c0 * cf.tnv, c1 * cf.tnv, zero};
          ds[1][0] = dt[o];
        }
        ds[1 + D][0] = dh[o];
        ds[2 + D][0] = dh[o];
      }
    }

    if (!BWD) {
      __syncthreads();
      if (tid < 3) {
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
      // row `win` of the block is the bias.
      const int npairs = (win + 1) * wout;
      T* acc = sm + ly.g_off[l];
      for (int q = tid; q < npairs; q += blockDim.x) {
        const int i = q / wout, o = q % wout;
        T s_acc = T(0);
        for (int p = 0; p < n_act; ++p) {
          const T* pp = sm + ly.pt0 + p * ly.pt;
          const T* dzp = pp + ly.dz_off;
          if (i == win) {
            s_acc += dzp[o];
          } else if (l == 0) {
            s_acc += pp[i] * dzp[o] + dzp[(1 + i) * ly.maxw + o];
          } else {
            const T* inp = pp + ly.st_off[l - 1] + S * win;
            T t = T(0);
#pragma unroll
            for (int s = 0; s < S; ++s) t += inp[s * win + i] * dzp[s * ly.maxw + o];
            s_acc += t;
          }
        }
        acc[q] += s_acc;
      }
      if (l == L - 1 && tid < 3) {
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
            if (i < win)
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

// Sum the per-block partials in block order; the last three entries are the
// squared-residual sums, returned as MSEs (÷ n_mean).  With `w` set, also the
// weighted loss w · mses after them.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const T* __restrict__ part, int G, int n_acc,
                const T* __restrict__ w, T n_mean, T* __restrict__ out) {
  for (int q = threadIdx.x; q < n_acc; q += blockDim.x) {
    T s = T(0);
    for (int b = 0; b < G; ++b) s += part[(size_t)b * n_acc + q];
    if (q >= n_acc - 3) s = s / n_mean;
    out[q] = s;
  }
  if (w != nullptr) {
    __syncthreads();
    if (threadIdx.x == 0)
      out[n_acc] = w[0] * out[n_acc - 3] + w[1] * out[n_acc - 2] + w[2] * out[n_acc - 1];
  }
}

template <typename T, int D, bool BWD>
void* kernel_ptr() {
  return reinterpret_cast<void*>(&ns_residual_kernel<T, D, BWD>);
}

void* pick_kernel(bool bwd, bool f64, int d_in) {
  if (f64) {
    if (d_in == 2) return bwd ? kernel_ptr<double, 2, true>() : kernel_ptr<double, 2, false>();
    return bwd ? kernel_ptr<double, 3, true>() : kernel_ptr<double, 3, false>();
  }
  if (d_in == 2) return bwd ? kernel_ptr<float, 2, true>() : kernel_ptr<float, 2, false>();
  return bwd ? kernel_ptr<float, 3, true>() : kernel_ptr<float, 3, false>();
}

bool make_net(const int* widths, int n_layers, int d_in, Net* net) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  if (d_in != 2 && d_in != 3) return false;
  if (widths[0] != d_in || widths[n_layers] != kDOut) return false;
  net->n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] < 1 || (l > 0 && widths[l] > kMaxWidth)) return false;
    net->widths[l] = widths[l];
  }
  return true;
}

template <typename T>
Coef<T> make_coef(const double* phys) {
  // phys = (nv, npre, scale, conv, visc, pres, time)
  Coef<T> c;
  c.cnv2 = T(phys[3] * phys[0] * phys[0]);
  c.vnv = T(phys[4] * phys[0]);
  c.pn = T(phys[5] * phys[1]);
  c.tnv = T(phys[6] * phys[0]);
  c.scale = T(phys[2]);
  return c;
}

template <typename T>
int launch(bool bwd, const void* x, const void* const* w, const void* const* b,
           const int* widths, int n_layers, int d_in, int n_eff,
           const double* phys, const void* gbar, double two_over_n,
           double n_mean, int with_loss, int P, int G, int smem, void* part,
           void* out, void* stream) {
  Net net;
  if (!make_net(widths, n_layers, d_in, &net)) return int(cudaErrorInvalidValue);
  Weights<T> wts;
  for (int l = 0; l < n_layers; ++l) {
    wts.w[l] = static_cast<const T*>(w[l]);
    wts.b[l] = static_cast<const T*>(b[l]);
  }
  for (int l = n_layers; l < kMaxLayers; ++l) {
    wts.w[l] = nullptr;
    wts.b[l] = nullptr;
  }
  Layout ly;
  ly.build(net, d_in, P, bwd);
  if (size_t(ly.total) * sizeof(T) != size_t(smem)) return int(cudaErrorInvalidValue);
  const bool f64 = sizeof(T) == 8;
  void* k = pick_kernel(bwd, f64, d_in);
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Coef<T> cf = make_coef<T>(phys);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gbar);
  T* pp = static_cast<T*>(part);
  const T ton = T(two_over_n);
  dim3 grid(G), block(32 * P);
  if (d_in == 2) {
    if (bwd) ns_residual_kernel<T, 2, true><<<grid, block, smem, st>>>(xp, wts, net, cf, gp, ton, n_eff, P, pp);
    else ns_residual_kernel<T, 2, false><<<grid, block, smem, st>>>(xp, wts, net, cf, gp, ton, n_eff, P, pp);
  } else {
    if (bwd) ns_residual_kernel<T, 3, true><<<grid, block, smem, st>>>(xp, wts, net, cf, gp, ton, n_eff, P, pp);
    else ns_residual_kernel<T, 3, false><<<grid, block, smem, st>>>(xp, wts, net, cf, gp, ton, n_eff, P, pp);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  reduce_partials<T><<<1, kReduceThreads, 0, st>>>(
      pp, G, ly.n_acc, with_loss ? gp : nullptr, T(n_mean), static_cast<T*>(out));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch plan for one call shape: points per block (P), grid size (G),
// dynamic shared memory bytes and the accumulator count.  Picks the largest
// P in {8, 4, 2, 1} whose block leaves room for two blocks per SM, else the
// largest that fits one.  Returns 0, or a cudaError_t / -1 when the widths
// do not fit.
int ns_residual_plan(int bwd, int f64, const int* widths, int n_layers,
                     int d_in, int n_eff, int* P_out, int* G_out,
                     int* smem_out, int* n_acc_out) {
  Net net;
  if (!make_net(widths, n_layers, d_in, &net)) return -1;
  const size_t elem = f64 ? 8 : 4;
  const size_t one_block = 227 * 1024, two_blocks = 113 * 1024;
  int P = 0;
  size_t bytes = 0;
  for (int pass = 0; pass < 2 && P == 0; ++pass) {
    for (int cand = 8; cand >= 1; cand /= 2) {
      Layout ly;
      ly.build(net, d_in, cand, bwd != 0);
      const size_t bb = size_t(ly.total) * elem;
      if (bb <= (pass == 0 ? two_blocks : one_block)) {
        P = cand;
        bytes = bb;
        break;
      }
    }
  }
  if (P == 0) return -1;
  Layout ly;
  ly.build(net, d_in, P, bwd != 0);
  void* k = pick_kernel(bwd != 0, f64 != 0, d_in);
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, 32 * P, bytes);
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
  *P_out = P;
  *G_out = G;
  *smem_out = int(bytes);
  *n_acc_out = ly.n_acc;
  return 0;
}

// One-pass backward: out = [dW_0, db_0, dW_1, db_1, ..., mse_mass, mse_u,
// mse_v] (+ loss = gbar · mses when with_loss).  part holds G * n_acc
// elements.  Returns cudaGetLastError() after the two launches.
int ns_residual_bwd_f64(const void* x, const void* const* w, const void* const* b,
                        const int* widths, int n_layers, int d_in, int n_eff,
                        const double* phys, const void* gbar, double two_over_n,
                        double n_mean, int with_loss, int P, int G, int smem,
                        void* part, void* out, void* stream) {
  return launch<double>(true, x, w, b, widths, n_layers, d_in, n_eff, phys, gbar,
                        two_over_n, n_mean, with_loss, P, G, smem, part, out, stream);
}

int ns_residual_bwd_f32(const void* x, const void* const* w, const void* const* b,
                        const int* widths, int n_layers, int d_in, int n_eff,
                        const double* phys, const void* gbar, double two_over_n,
                        double n_mean, int with_loss, int P, int G, int smem,
                        void* part, void* out, void* stream) {
  return launch<float>(true, x, w, b, widths, n_layers, d_in, n_eff, phys, gbar,
                       two_over_n, n_mean, with_loss, P, G, smem, part, out, stream);
}

// Forward: out = [mse_mass, mse_u, mse_v].
int ns_residual_fwd_f64(const void* x, const void* const* w, const void* const* b,
                        const int* widths, int n_layers, int d_in, int n_eff,
                        const double* phys, double n_mean, int P, int G, int smem,
                        void* part, void* out, void* stream) {
  return launch<double>(false, x, w, b, widths, n_layers, d_in, n_eff, phys, nullptr,
                        0.0, n_mean, 0, P, G, smem, part, out, stream);
}

int ns_residual_fwd_f32(const void* x, const void* const* w, const void* const* b,
                        const int* widths, int n_layers, int d_in, int n_eff,
                        const double* phys, double n_mean, int P, int G, int smem,
                        void* part, void* out, void* stream) {
  return launch<float>(false, x, w, b, widths, n_layers, d_in, n_eff, phys, nullptr,
                       0.0, n_mean, 0, P, G, smem, part, out, stream);
}

}  // extern "C"
