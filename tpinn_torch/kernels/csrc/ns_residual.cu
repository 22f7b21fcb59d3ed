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
// What bounds it on this card: operations.  At widths 2-32-32-32-3 the
// backward needs 69,830 floating-point operations per point
// (ns_flops_per_point in chip_smoke.py: 2.3e4 forward over 5 streams, the
// dW contractions and the back-propagation, the elementwise Taylor rules)
// against 16 bytes of input in float64, so its bound is the operations over
// the 67 TFLOP/s of the float64 tensor cores.
//
// Design (taylor_mlp.cuh), as the TPU kernel's _taylor_streams and
// _reverse_walk did it with one matrix product per layer and chunk:
//   * a block of 512 threads walks tiles of P points (8 at n ≤ 8·SMs, the
//     largest that fits above: 16 in float64, 32 in float32) and keeps each
//     layer's streams of a tile as one stream-major matrix (row = s·P + p)
//     in shared memory, widths padded to multiples of 8 with zero weights;
//   * per hidden layer one phase: each warp job takes 8 points x 8 neurons
//     and runs the products Z_s = A_s·W of all S streams as independent
//     DMMA chains sharing W's operand (mma.sync m16n8k8 on the float64
//     tensor cores, two streams as its 16 rows; an odd S's last stream on
//     m8n8k4), then the tanh-Taylor epilogue in registers; backward, one
//     phase per layer: the same stream-grouped jobs for dA = DZ·Wᵀ followed
//     by the previous layer's cotangent rule in registers, and beside them
//     dW += Aᵀ·DZ over the tile's rows (m16n8k8 DMMA tiles) into
//     accumulators that stay in shared memory across the block's tiles (or,
//     for nets too large for that, in the block's own partial slice);
//     layer 0 stays in closed form (its gradient input streams are basis
//     vectors, its Hessian input streams zero); float32 runs the same jobs
//     on IEEE FFMA register tiles (no TF32);
//   * the weights are staged once per block, and the next tile's points
//     are prefetched, by cp.async;
//   * one launch: each block writes its partials, and the last block to
//     take the integer ticket sums them in block order 0..G-1 (no float
//     atomics), so two calls at the same parameters agree bit for bit (the
//     paired-difference accept test of docs/DESIGN.md §3 needs that);
//   * rows at and beyond n_valid are never read (their cotangent is zero),
//     and the cotangents use the static n_mean.  The mass row is not
//     multiplied by `scale`; the momentum rows are.
//
// The layout, the products, the kernel body, the launch plan and the launch
// are shared with poisson_residual.cu through taylor_mlp.cuh; this file holds
// the (u, v, p) head: the residual rows and their cotangents.

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
// momentum u, momentum v); every head stream can carry a cotangent.  Head
// stream s of output o of a point is hd[s·ss + o].
template <typename TT, int DD>
struct NSHead {
  using T = TT;
  static constexpr int D = DD;
  static constexpr int S = 1 + D + kNh;
  static constexpr int kDOut = 3;
  static constexpr int kNsq = 3;
  static constexpr int kExtra = 0;
  static constexpr int kLiveLo = 0, kLiveHi = S;
  static constexpr int OFF = (D == 3) ? 1 : 0;  // spatial column j is input j+OFF
  using Args = Coef<T>;

  __device__ static const T* extra(const Args&) { return nullptr; }

  // r_mass, r_u, r_v at one point from the head streams (momentum rows
  // scaled, mass row not).
  __device__ __forceinline__ static void rows(const T* hd, int ss, const T*,
                                              const Args& cf, T r[kNsq]) {
    const T* val = hd;
    const T* gx = hd + (1 + OFF) * ss;
    const T* gy = hd + (2 + OFF) * ss;
    const T* hx = hd + (1 + D) * ss;
    const T* hy = hd + (2 + D) * ss;
    r[0] = gx[0] + gy[1];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      T inner = cf.cnv2 * (val[0] * gx[k] + val[1] * gy[k]) -
                cf.vnv * (hx[k] + hy[k]) + cf.pn * (k == 0 ? gx[2] : gy[2]);
      if (D == 3) inner += cf.tnv * hd[ss + k];  // ∂t stream = column 0
      r[1 + k] = inner * cf.scale;
    }
  }

  // Cotangents of the head streams for the MSE cotangents g:
  // c = g · 2r/n_mean (· scale on the momentum rows); stream s of output o
  // goes to dz[s·dss + o].
  __device__ __forceinline__ static void cotangents(
      const T* hd, int ss, const Args& cf, const T r[kNsq], const T g[kNsq],
      T two_over_n, T* dz, int dss) {
    const T c_m = g[0] * two_over_n * r[0];
    const T c0 = g[1] * two_over_n * r[1] * cf.scale;
    const T c1 = g[2] * two_over_n * r[2] * cf.scale;
    const T* val = hd;
    const T* gx = hd + (1 + OFF) * ss;
    const T* gy = hd + (2 + OFF) * ss;
    const T zero = T(0);
    const T dval[3] = {c0 * cf.cnv2 * gx[0] + c1 * cf.cnv2 * gx[1],
                       c0 * cf.cnv2 * gy[0] + c1 * cf.cnv2 * gy[1], zero};
    const T dgx[3] = {c0 * cf.cnv2 * val[0] + c_m, c1 * cf.cnv2 * val[0],
                      c0 * cf.pn};
    const T dgy[3] = {c0 * cf.cnv2 * val[1], c1 * cf.cnv2 * val[1] + c_m,
                      c1 * cf.pn};
    const T dh[3] = {-c0 * cf.vnv, -c1 * cf.vnv, zero};
    const T dt[3] = {c0 * cf.tnv, c1 * cf.tnv, zero};
#pragma unroll
    for (int o = 0; o < kDOut; ++o) {
      dz[o] = dval[o];
      dz[(1 + OFF) * dss + o] = dgx[o];
      dz[(2 + OFF) * dss + o] = dgy[o];
      if (D == 3) dz[dss + o] = dt[o];
      dz[(1 + D) * dss + o] = dh[o];
      dz[(2 + D) * dss + o] = dh[o];
    }
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
           void* out, void* ticket, void* stream) {
  Net net;
  if (!make_ns_net(widths, n_layers, d_in, &net)) return int(cudaErrorInvalidValue);
  const Coef<T> cf = make_coef<T>(phys);
#define TPINN_NS_LAUNCH(DIN, B)                                                 \
  return launch_residual<NSHead<T, DIN>, B>(x, w, b, net, n_eff, cf, gbar,      \
                                            two_over_n, n_mean, with_loss, P,   \
                                            G, smem, part, out, ticket, stream)
  if (d_in == 2) {
    if (bwd) TPINN_NS_LAUNCH(2, true);
    TPINN_NS_LAUNCH(2, false);
  }
  if (bwd) TPINN_NS_LAUNCH(3, true);
  TPINN_NS_LAUNCH(3, false);
#undef TPINN_NS_LAUNCH
}

}  // namespace

extern "C" {

// Launch plan for one call shape (see plan_blocks in taylor_mlp.cuh).
int ns_residual_plan(int bwd, int f64, const int* widths, int n_layers,
                     int d_in, int n_eff, int* P_out, int* G_out,
                     int* smem_out, int* n_acc_out) {
  Net net;
  if (!make_ns_net(widths, n_layers, d_in, &net)) return -1;
  return plan_blocks(net, d_in, 3, 0, bwd != 0, f64 ? 8 : 4,
                     bwd_kernel(f64 != 0, d_in), n_eff, P_out, G_out,
                     smem_out, n_acc_out);
}

// One-pass backward: out = [dW_0, db_0, dW_1, db_1, ..., mse_mass, mse_u,
// mse_v] (+ loss = gbar · mses when with_loss).  part holds G * n_acc
// elements; ticket is a device unsigned, zero between launches.  Returns
// cudaGetLastError() after the launch.
int ns_residual_bwd_f64(const void* x, const void* const* w, const void* const* b,
                        const int* widths, int n_layers, int d_in, int n_eff,
                        const double* phys, const void* gbar, double two_over_n,
                        double n_mean, int with_loss, int P, int G, int smem,
                        void* part, void* out, void* ticket, void* stream) {
  return launch<double>(true, x, w, b, widths, n_layers, d_in, n_eff, phys, gbar,
                        two_over_n, n_mean, with_loss, P, G, smem, part, out,
                        ticket, stream);
}

int ns_residual_bwd_f32(const void* x, const void* const* w, const void* const* b,
                        const int* widths, int n_layers, int d_in, int n_eff,
                        const double* phys, const void* gbar, double two_over_n,
                        double n_mean, int with_loss, int P, int G, int smem,
                        void* part, void* out, void* ticket, void* stream) {
  return launch<float>(true, x, w, b, widths, n_layers, d_in, n_eff, phys, gbar,
                       two_over_n, n_mean, with_loss, P, G, smem, part, out,
                       ticket, stream);
}

// Forward: out = [mse_mass, mse_u, mse_v].
int ns_residual_fwd_f64(const void* x, const void* const* w, const void* const* b,
                        const int* widths, int n_layers, int d_in, int n_eff,
                        const double* phys, double n_mean, int P, int G, int smem,
                        void* part, void* out, void* ticket, void* stream) {
  return launch<double>(false, x, w, b, widths, n_layers, d_in, n_eff, phys, nullptr,
                        0.0, n_mean, 0, P, G, smem, part, out, ticket, stream);
}

int ns_residual_fwd_f32(const void* x, const void* const* w, const void* const* b,
                        const int* widths, int n_layers, int d_in, int n_eff,
                        const double* phys, double n_mean, int P, int G, int smem,
                        void* part, void* out, void* ticket, void* stream) {
  return launch<float>(false, x, w, b, widths, n_layers, d_in, n_eff, phys, nullptr,
                       0.0, n_mean, 0, P, G, smem, part, out, ticket, stream);
}

}  // extern "C"
