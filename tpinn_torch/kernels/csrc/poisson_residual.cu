// Fused Poisson residual kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the two Poisson-residual Pallas kernels of
// tpinn/pallas/mlp_bundle.py:
//   * poisson_residual_bwd  <- _poisson_bwd_kernel (mlp_bundle.py:1268),
//     launched by _poisson_mse_backward (:1399).  One pass per point:
//     recompute the Taylor streams of the scalar tanh MLP u(x, y), form the
//     residual r = (∂²u/∂x² + ∂²u/∂y² + f)·scale, sum r², and walk the layers
//     backward for every dW/db of the MSE cotangent ḡ.  The residual touches
//     only the two Hessian-diagonal head streams, so the head cotangents are
//     (0, 0, 0, c, c) with c = ḡ·(2/n_mean)·r·scale: the value and gradient
//     head streams are structural zeros, the head products skip their rows,
//     and the head bias gradient is exactly zero.  Called with the loss
//     weight as ḡ it is the one-pass training objective (weighted loss, raw
//     MSE, parameter gradients).
//   * poisson_residual_fwd  <- _poisson_kernel (mlp_bundle.py:1209), launched
//     by _poisson_mse_forward (:1365): the same forward streams, only Σ r².
//
// What bounds it on this card: operations.  At the examples' widths
// 2-20-20-20-1 the backward needs 27,648 floating-point operations per point
// (poisson_flops_per_point in chip_smoke.py) against 24 bytes of input in
// float64 (x, y, f), so its bound is the operations over the 67 TFLOP/s of
// the float64 tensor cores.
//
// Design: ns_residual.cu's (taylor_mlp.cuh).  A block walks tiles of P
// points with every layer's streams of a tile as one stream-major matrix;
// the layer products run on the float64 tensor cores (DMMA), all five
// streams of 8 points per warp job, with widths padded from 20 to 24 (the
// padded neurons cost a sixth of the products, where the one-warp-per-point
// design idled 12 of 32 lanes); the head products and the head's backward
// cover only the two Hessian-diagonal row blocks; the block partials are
// summed in a fixed order by the last block (integer ticket), so two calls
// at the same θ agree bit for bit (L-BFGS-B's line search compares values).
//
// Unlike the TPU kernel, which rides f in a zero-padding feature row of the
// input stream, f is its own pointer, copied into the tile beside x.  Rows at
// and beyond n_valid are never read; the cotangents use the static n_mean.
// Input columns are (x, y): d_in = 2 only.

#include "taylor_mlp.cuh"

namespace {

template <typename T>
struct PoissonArgs {
  const T* f;  // per-point forcing, (n,)
  T scale;     // 1 / normalization
};

// The Poisson head: one output u; one squared sum; only the two
// Hessian-diagonal head streams (rows 3P..5P of the head matrix) can carry
// a cotangent.  Head stream s of a point is hd[s·ss]; its forcing f is the
// extra input column.
template <typename TT>
struct PoissonHead {
  using T = TT;
  static constexpr int D = 2;
  static constexpr int S = 1 + D + kNh;
  static constexpr int kDOut = 1;
  static constexpr int kNsq = 1;
  static constexpr int kExtra = 1;
  static constexpr int kLiveLo = 1 + D, kLiveHi = S;
  using Args = PoissonArgs<T>;

  __device__ static const T* extra(const Args& a) { return a.f; }

  __device__ __forceinline__ static void rows(const T* hd, int ss, const T* xr,
                                              const Args& a, T r[kNsq]) {
    r[0] = (hd[(1 + D) * ss] + hd[(2 + D) * ss] + xr[D]) * a.scale;
  }

  __device__ __forceinline__ static void cotangents(
      const T*, int, const Args& a, const T r[kNsq], const T g[kNsq],
      T two_over_n, T* dz, int dss) {
    const T c = g[0] * two_over_n * r[0] * a.scale;
    dz[(1 + D) * dss] = c;
    dz[(2 + D) * dss] = c;
  }
};

// The backward instantiation; the launch plan reads its occupancy (the
// forward shares the backward's plan).
void* bwd_kernel(bool f64) {
  return f64 ? reinterpret_cast<void*>(&residual_kernel<PoissonHead<double>, true>)
             : reinterpret_cast<void*>(&residual_kernel<PoissonHead<float>, true>);
}

template <typename T>
int launch(bool bwd, const void* x, const void* f, const void* const* w,
           const void* const* b, const int* widths, int n_layers, int n_eff,
           double scale, const void* gbar, double two_over_n, double n_mean,
           int with_loss, int P, int G, int smem, void* part, void* out,
           void* ticket, void* stream) {
  Net net;
  if (!make_net(widths, n_layers, 2, 1, &net)) return int(cudaErrorInvalidValue);
  PoissonArgs<T> args;
  args.f = static_cast<const T*>(f);
  args.scale = T(scale);
  if (bwd)
    return launch_residual<PoissonHead<T>, true>(x, w, b, net, n_eff, args, gbar,
                                                 two_over_n, n_mean, with_loss, P, G,
                                                 smem, part, out, ticket, stream);
  return launch_residual<PoissonHead<T>, false>(x, w, b, net, n_eff, args, gbar,
                                                two_over_n, n_mean, with_loss, P, G,
                                                smem, part, out, ticket, stream);
}

}  // namespace

extern "C" {

// Launch plan for one call shape (see plan_blocks in taylor_mlp.cuh).
int poisson_residual_plan(int bwd, int f64, const int* widths, int n_layers,
                          int n_eff, int* P_out, int* G_out, int* smem_out,
                          int* n_acc_out) {
  Net net;
  if (!make_net(widths, n_layers, 2, 1, &net)) return -1;
  return plan_blocks(net, 2, 1, 1, bwd != 0, f64 ? 8 : 4, bwd_kernel(f64 != 0),
                     n_eff, P_out, G_out, smem_out, n_acc_out);
}

// One-pass backward: out = [dW_0, db_0, dW_1, db_1, ..., mse] (+ loss =
// gbar[0] · mse when with_loss).  part holds G * n_acc elements; ticket is
// a device unsigned, zero between launches.  Returns cudaGetLastError()
// after the launch.
int poisson_residual_bwd_f64(const void* x, const void* f, const void* const* w,
                             const void* const* b, const int* widths, int n_layers,
                             int n_eff, double scale, const void* gbar,
                             double two_over_n, double n_mean, int with_loss, int P,
                             int G, int smem, void* part, void* out, void* ticket,
                             void* stream) {
  return launch<double>(true, x, f, w, b, widths, n_layers, n_eff, scale, gbar,
                        two_over_n, n_mean, with_loss, P, G, smem, part, out, ticket,
                        stream);
}

int poisson_residual_bwd_f32(const void* x, const void* f, const void* const* w,
                             const void* const* b, const int* widths, int n_layers,
                             int n_eff, double scale, const void* gbar,
                             double two_over_n, double n_mean, int with_loss, int P,
                             int G, int smem, void* part, void* out, void* ticket,
                             void* stream) {
  return launch<float>(true, x, f, w, b, widths, n_layers, n_eff, scale, gbar,
                       two_over_n, n_mean, with_loss, P, G, smem, part, out, ticket,
                       stream);
}

// Forward: out = [mse].
int poisson_residual_fwd_f64(const void* x, const void* f, const void* const* w,
                             const void* const* b, const int* widths, int n_layers,
                             int n_eff, double scale, double n_mean, int P, int G,
                             int smem, void* part, void* out, void* ticket,
                             void* stream) {
  return launch<double>(false, x, f, w, b, widths, n_layers, n_eff, scale, nullptr,
                        0.0, n_mean, 0, P, G, smem, part, out, ticket, stream);
}

int poisson_residual_fwd_f32(const void* x, const void* f, const void* const* w,
                             const void* const* b, const int* widths, int n_layers,
                             int n_eff, double scale, double n_mean, int P, int G,
                             int smem, void* part, void* out, void* ticket,
                             void* stream) {
  return launch<float>(false, x, f, w, b, widths, n_layers, n_eff, scale, nullptr,
                       0.0, n_mean, 0, P, G, smem, part, out, ticket, stream);
}

}  // extern "C"
