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
//     head streams are structural zeros, their head-layer contractions are
//     skipped, and the head bias gradient is exactly zero.  Called with the
//     loss weight as ḡ it is the one-pass training objective (weighted loss,
//     raw MSE, parameter gradients).
//   * poisson_residual_fwd  <- _poisson_kernel (mlp_bundle.py:1209), launched
//     by _poisson_mse_forward (:1365): the same forward streams, only Σ r².
//
// What bounds it on this card.  At the examples' widths 2-20-20-20-1 the
// backward needs about 2.8e4 floating-point operations per point and reads
// 24 bytes per point in float64 (x, y, f): it is bound by operations.  The
// design is ns_residual.cu's (taylor_mlp.cuh): one warp per point, a block
// of P points walking tiles in a grid-stride loop, the streams and
// accumulators in shared memory, block partials summed in a fixed order by a
// second launch, so two calls at the same θ agree bit for bit (L-BFGS-B's
// line search compares values).  Width 20 leaves 12 lanes of each warp idle.
//
// Unlike the TPU kernel, which rides f in a zero-padding feature row of the
// input stream, f is its own pointer.  Rows at and beyond n_valid are never
// processed; the cotangents use the static n_mean.  Input columns are
// (x, y): d_in = 2 only.

#include "taylor_mlp.cuh"

namespace {

template <typename T>
struct PoissonArgs {
  const T* f;  // per-point forcing, (n,)
  T scale;     // 1 / normalization
};

// The Poisson head: one output u; one squared sum; only the two
// Hessian-diagonal head streams can carry a cotangent.
template <typename TT>
struct PoissonHead {
  using T = TT;
  static constexpr int D = 2;
  static constexpr int S = 1 + D + kNh;
  static constexpr int kDOut = 1;
  static constexpr int kNsq = 1;
  using Args = PoissonArgs<T>;

  __host__ __device__ static constexpr bool head_live(int s) { return s > D; }

  __device__ __forceinline__ static void rows(const T* hd, const Args& a,
                                              int row, T r[kNsq]) {
    r[0] = (hd[1 + D] + hd[2 + D] + a.f[row]) * a.scale;
  }

  __device__ __forceinline__ static void cotangents(
      const T*, const Args& a, const T r[kNsq], const T g[kNsq], T two_over_n,
      int, T ds[S][kNpl]) {
    const T c = g[0] * two_over_n * r[0] * a.scale;
    ds[1 + D][0] = c;
    ds[2 + D][0] = c;
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
           void* stream) {
  Net net;
  if (!make_net(widths, n_layers, 2, 1, &net)) return int(cudaErrorInvalidValue);
  PoissonArgs<T> args;
  args.f = static_cast<const T*>(f);
  args.scale = T(scale);
  if (bwd)
    return launch_residual<PoissonHead<T>, true>(x, w, b, net, n_eff, args, gbar, two_over_n,
                                                 n_mean, with_loss, P, G, smem, part, out, stream);
  return launch_residual<PoissonHead<T>, false>(x, w, b, net, n_eff, args, gbar, two_over_n,
                                                n_mean, with_loss, P, G, smem, part, out, stream);
}

}  // namespace

extern "C" {

// Launch plan for one call shape (see plan_blocks in taylor_mlp.cuh).
int poisson_residual_plan(int bwd, int f64, const int* widths, int n_layers,
                          int n_eff, int* P_out, int* G_out, int* smem_out,
                          int* n_acc_out) {
  Net net;
  if (!make_net(widths, n_layers, 2, 1, &net)) return -1;
  return plan_blocks(net, 2, 1, 1, bwd != 0, f64 ? 8 : 4,
                     bwd_kernel(f64 != 0), n_eff, P_out, G_out,
                     smem_out, n_acc_out);
}

// One-pass backward: out = [dW_0, db_0, dW_1, db_1, ..., mse] (+ loss =
// gbar[0] · mse when with_loss).  part holds G * n_acc elements.  Returns
// cudaGetLastError() after the two launches.
int poisson_residual_bwd_f64(const void* x, const void* f, const void* const* w,
                             const void* const* b, const int* widths, int n_layers,
                             int n_eff, double scale, const void* gbar,
                             double two_over_n, double n_mean, int with_loss, int P,
                             int G, int smem, void* part, void* out, void* stream) {
  return launch<double>(true, x, f, w, b, widths, n_layers, n_eff, scale, gbar,
                        two_over_n, n_mean, with_loss, P, G, smem, part, out, stream);
}

int poisson_residual_bwd_f32(const void* x, const void* f, const void* const* w,
                             const void* const* b, const int* widths, int n_layers,
                             int n_eff, double scale, const void* gbar,
                             double two_over_n, double n_mean, int with_loss, int P,
                             int G, int smem, void* part, void* out, void* stream) {
  return launch<float>(true, x, f, w, b, widths, n_layers, n_eff, scale, gbar,
                       two_over_n, n_mean, with_loss, P, G, smem, part, out, stream);
}

// Forward: out = [mse].
int poisson_residual_fwd_f64(const void* x, const void* f, const void* const* w,
                             const void* const* b, const int* widths, int n_layers,
                             int n_eff, double scale, double n_mean, int P, int G,
                             int smem, void* part, void* out, void* stream) {
  return launch<double>(false, x, f, w, b, widths, n_layers, n_eff, scale, nullptr,
                        0.0, n_mean, 0, P, G, smem, part, out, stream);
}

int poisson_residual_fwd_f32(const void* x, const void* f, const void* const* w,
                             const void* const* b, const int* widths, int n_layers,
                             int n_eff, double scale, double n_mean, int P, int G,
                             int smem, void* part, void* out, void* stream) {
  return launch<float>(false, x, f, w, b, widths, n_layers, n_eff, scale, nullptr,
                       0.0, n_mean, 0, P, G, smem, part, out, stream);
}

}  // extern "C"
