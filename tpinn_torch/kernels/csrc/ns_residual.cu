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
//
// The layout, the stream propagation, the kernel body, the reduction and the
// launch plan are shared with poisson_residual.cu through taylor_mlp.cuh;
// this file holds the (u, v, p) head: the residual rows and their cotangents.

#include "taylor_mlp.cuh"

namespace {

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

// The Navier–Stokes head: outputs (u, v, p); three squared sums (mass,
// momentum u, momentum v); every head stream can carry a cotangent.
template <typename TT, int DD>
struct NSHead {
  using T = TT;
  static constexpr int D = DD;
  static constexpr int S = 1 + D + kNh;
  static constexpr int kDOut = 3;
  static constexpr int kNsq = 3;
  static constexpr int OFF = (D == 3) ? 1 : 0;  // spatial column j is input j+OFF
  using Args = Coef<T>;

  __host__ __device__ static constexpr bool head_live(int) { return true; }

  // r_mass, r_u, r_v at one point from the head streams (momentum rows
  // scaled, mass row not).
  __device__ __forceinline__ static void rows(const T* hd, const Args& cf, int,
                                              T r[kNsq]) {
    const T* val = hd;
    const T* gx = hd + (1 + OFF) * kDOut;
    const T* gy = hd + (2 + OFF) * kDOut;
    const T* hx = hd + (1 + D) * kDOut;
    const T* hy = hd + (2 + D) * kDOut;
    r[0] = gx[0] + gy[1];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      T inner = cf.cnv2 * (val[0] * gx[k] + val[1] * gy[k]) -
                cf.vnv * (hx[k] + hy[k]) + cf.pn * (k == 0 ? gx[2] : gy[2]);
      if (D == 3) inner += cf.tnv * hd[kDOut + k];  // ∂t stream = column 0
      r[1 + k] = inner * cf.scale;
    }
  }

  // Cotangents of output o's head streams for the MSE cotangents g:
  // c = g · 2r/n_mean (· scale on the momentum rows).
  __device__ __forceinline__ static void cotangents(
      const T* hd, const Args& cf, const T r[kNsq], const T g[kNsq],
      T two_over_n, int o, T ds[S][kNpl]) {
    const T c_m = g[0] * two_over_n * r[0];
    const T c0 = g[1] * two_over_n * r[1] * cf.scale;
    const T c1 = g[2] * two_over_n * r[2] * cf.scale;
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
};

// The backward instantiation for a call shape; the launch plan reads its
// occupancy (the forward shares the backward's plan).
void* bwd_kernel(bool f64, int d_in) {
  if (f64)
    return d_in == 2 ? reinterpret_cast<void*>(&residual_kernel<NSHead<double, 2>, true>)
                     : reinterpret_cast<void*>(&residual_kernel<NSHead<double, 3>, true>);
  return d_in == 2 ? reinterpret_cast<void*>(&residual_kernel<NSHead<float, 2>, true>)
                   : reinterpret_cast<void*>(&residual_kernel<NSHead<float, 3>, true>);
}

bool make_ns_net(const int* widths, int n_layers, int d_in, Net* net) {
  return (d_in == 2 || d_in == 3) && make_net(widths, n_layers, d_in, 3, net);
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
  if (!make_ns_net(widths, n_layers, d_in, &net)) return int(cudaErrorInvalidValue);
  const Coef<T> cf = make_coef<T>(phys);
  if (d_in == 2) {
    if (bwd)
      return launch_residual<NSHead<T, 2>, true>(x, w, b, net, n_eff, cf, gbar, two_over_n,
                                                 n_mean, with_loss, P, G, smem, part, out, stream);
    return launch_residual<NSHead<T, 2>, false>(x, w, b, net, n_eff, cf, gbar, two_over_n,
                                                n_mean, with_loss, P, G, smem, part, out, stream);
  }
  if (bwd)
    return launch_residual<NSHead<T, 3>, true>(x, w, b, net, n_eff, cf, gbar, two_over_n,
                                               n_mean, with_loss, P, G, smem, part, out, stream);
  return launch_residual<NSHead<T, 3>, false>(x, w, b, net, n_eff, cf, gbar, two_over_n,
                                              n_mean, with_loss, P, G, smem, part, out, stream);
}

}  // namespace

extern "C" {

// Launch plan for one call shape (see plan_blocks in taylor_mlp.cuh).
int ns_residual_plan(int bwd, int f64, const int* widths, int n_layers,
                     int d_in, int n_eff, int* P_out, int* G_out,
                     int* smem_out, int* n_acc_out) {
  Net net;
  if (!make_ns_net(widths, n_layers, d_in, &net)) return -1;
  return plan_blocks(net, d_in, 3, 3, bwd != 0, f64 ? 8 : 4,
                     bwd_kernel(f64 != 0, d_in), n_eff, P_out,
                     G_out, smem_out, n_acc_out);
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
