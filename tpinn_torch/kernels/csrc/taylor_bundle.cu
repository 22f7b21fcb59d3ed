// Kernel 5: the Taylor bundle of a tanh MLP (sm_90a, plain C interface).
//
// Replaces the JAX package's `_kernel` (tpinn/pallas/mlp_bundle.py:235),
// launched by `mlp_taylor_bundle` (:1546).  For every point x (d_in columns)
// it writes the network's value (n, d_out), its Jacobian (n, d_out, dim) and
// its Hessian diagonal (n, d_out, dim) over input columns 0..dim-1, row-major.
// 1 + 2·dim Taylor streams pass through the layers:
//   value   v' = tanh(z_v + b)
//   tangent g'_k = tanh'(z_v) z_gk                (input: the basis vector e_k)
//   second  h'_k = −2 v tanh' z_gk² + tanh' z_hk  (input: zero)
// and the head layer is linear, with the bias on the value stream only.  No
// reduction: each point is independent, so two calls at the same parameters
// agree bit for bit whatever the grid.
//
// Design: one warp per point, P points per block, the weights in shared
// memory (row stride width + 1), each point's streams in two ping-pong
// buffers of (1 + 2·dim)·max_width elements; lane o computes output neuron o
// (and o + 32) of every stream.  What bounds it on the H100: operations
// (about 23k per point at 2-32-32-32-3, dim 2, against 136 bytes of input
// and output in float64), issued as serial per-lane dot products over shared
// memory.  The Hessian-stream set differs from the fused residual kernels'
// (taylor_mlp.cuh carries two streams on the spatial columns), so the
// propagation is its own here and kernels 1-4 keep their arithmetic.

#include "taylor_mlp.cuh"

namespace {

constexpr int kBundleMaxPoints = 8;

// Shared-memory layout, in elements of T (mirrored by bundle_smem_elems in
// tpinn_torch/kernels/mlp_bundle.py).
struct BundleLayout {
  int w_off[kMaxLayers];
  int b_off[kMaxLayers];
  int pt0;   // start of the per-point regions
  int buf;   // one stream buffer: S * maxw
  int pt;    // point stride: the input row, then two stream buffers
  int total;

  __host__ __device__ void build(const Net& net, int d_in, int S, int P) {
    int off = 0, maxw = 0;
    for (int l = 0; l < net.n_layers; ++l) {
      const int wi = net.widths[l], wo = net.widths[l + 1];
      w_off[l] = off;
      off += wi * (wo + 1);
      b_off[l] = off;
      off += wo;
      if (wo > maxw) maxw = wo;
    }
    pt0 = off;
    buf = S * maxw;
    pt = d_in + 2 * buf;
    total = pt0 + P * pt;
  }
};

template <typename T, int D, int DIM>
__global__ void __launch_bounds__(32 * kBundleMaxPoints)
taylor_bundle_kernel(const T* __restrict__ x, Weights<T> wts, Net net, int n,
                     int P, T* __restrict__ value, T* __restrict__ jac,
                     T* __restrict__ hdiag) {
  constexpr int S = 1 + 2 * DIM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  BundleLayout ly;
  ly.build(net, D, S, P);
  const int L = net.n_layers;
  const int d_out = net.widths[L];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int l = 0; l < L; ++l) {
    const int wi = net.widths[l], wo = net.widths[l + 1];
    for (int q = tid; q < wi * wo; q += blockDim.x)
      sm[ly.w_off[l] + (q / wo) * (wo + 1) + q % wo] = wts.w[l][q];
    for (int q = tid; q < wo; q += blockDim.x) sm[ly.b_off[l] + q] = wts.b[l][q];
  }
  __syncthreads();

  T* xin = sm + ly.pt0 + warp * ly.pt;
  T* bufs[2] = {xin + D, xin + D + ly.buf};
  const int n_tiles = (n + P - 1) / P;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row = tile * P + warp;
    if (row >= n) continue;  // no block barrier below: a warp may skip
    if (lane < D) xin[lane] = x[(size_t)row * D + lane];
    __syncwarp();
    for (int l = 0; l < L; ++l) {
      const int win = net.widths[l], wout = net.widths[l + 1];
      const int ldw = wout + 1;
      const T* W = sm + ly.w_off[l];
      const T* bb = sm + ly.b_off[l];
      const T* in = bufs[(l + 1) & 1];
      T* out = bufs[l & 1];
      const bool hidden = l + 1 < L;
#pragma unroll
      for (int r = 0; r < kNpl; ++r) {
        const int o = lane + 32 * r;
        if (o >= wout) continue;
        T z[S];
        if (l == 0) {
          T acc = T(0);
          for (int i = 0; i < D; ++i) acc += xin[i] * W[i * ldw + o];
          z[0] = acc + bb[o];
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            z[1 + k] = W[k * ldw + o];
            z[1 + DIM + k] = T(0);
          }
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
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            const T zg = z[1 + k];
            out[(1 + k) * wout + o] = tp * zg;
            out[(1 + DIM + k) * wout + o] = a * zg * zg + tp * z[1 + DIM + k];
          }
        } else {
          const size_t po = (size_t)row * d_out + o;
          value[po] = z[0];
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            jac[po * DIM + k] = z[1 + k];
            hdiag[po * DIM + k] = z[1 + DIM + k];
          }
        }
      }
      __syncwarp();
    }
  }
}

template <typename T>
void* kernel_of(int d_in, int dim) {
  switch (d_in * 4 + dim) {
    case 2 * 4 + 1: return reinterpret_cast<void*>(&taylor_bundle_kernel<T, 2, 1>);
    case 2 * 4 + 2: return reinterpret_cast<void*>(&taylor_bundle_kernel<T, 2, 2>);
    case 3 * 4 + 1: return reinterpret_cast<void*>(&taylor_bundle_kernel<T, 3, 1>);
    case 3 * 4 + 2: return reinterpret_cast<void*>(&taylor_bundle_kernel<T, 3, 2>);
    case 3 * 4 + 3: return reinterpret_cast<void*>(&taylor_bundle_kernel<T, 3, 3>);
    default: return nullptr;
  }
}

bool bundle_net(const int* widths, int n_layers, int d_in, int dim, Net* net) {
  if (d_in < 2 || d_in > 3 || dim < 1 || dim > d_in) return false;
  if (n_layers < 1) return false;
  return make_net(widths, n_layers, d_in, widths[n_layers], net);
}

}  // namespace

extern "C" {

// Launch plan: points per block P (the largest in {8, 4, 2, 1} whose block
// leaves room for two blocks per SM, else the largest that fits one), grid
// size G (resident blocks, at most one per tile) and dynamic shared memory
// bytes.  Returns 0, or a cudaError_t / -1 when the net does not fit.
int taylor_bundle_plan(int f64, const int* widths, int n_layers, int d_in,
                       int dim, int n, int* P_out, int* G_out, int* smem_out) {
  Net net;
  if (!bundle_net(widths, n_layers, d_in, dim, &net)) return -1;
  const size_t elem = f64 ? sizeof(double) : sizeof(float);
  void* k = f64 ? kernel_of<double>(d_in, dim) : kernel_of<float>(d_in, dim);
  if (k == nullptr) return -1;
  const size_t one_block = 227 * 1024, two_blocks = 113 * 1024;
  int P = 0;
  size_t bytes = 0;
  for (int pass = 0; pass < 2 && P == 0; ++pass) {
    for (int cand = kBundleMaxPoints; cand >= 1; cand /= 2) {
      BundleLayout ly;
      ly.build(net, d_in, 1 + 2 * dim, cand);
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
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, 32 * P, bytes);
  if (err != cudaSuccess) return int(err);
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  const int n_tiles = (n + P - 1) / P;
  int G = per_sm * sms;
  if (n_tiles < G) G = n_tiles;
  if (G < 1) G = 1;
  *P_out = P;
  *G_out = G;
  *smem_out = int(bytes);
  return 0;
}

}  // extern "C"

namespace {

template <typename T>
int launch_bundle(const void* x, const void* const* w, const void* const* b,
                  const int* widths, int n_layers, int d_in, int dim, int n,
                  int P, int G, int smem, void* value, void* jac, void* hdiag,
                  void* stream) {
  Net net;
  if (!bundle_net(widths, n_layers, d_in, dim, &net)) return int(cudaErrorInvalidValue);
  BundleLayout ly;
  ly.build(net, d_in, 1 + 2 * dim, P);
  if (size_t(ly.total) * sizeof(T) != size_t(smem) || P < 1 || P > kBundleMaxPoints)
    return int(cudaErrorInvalidValue);
  Weights<T> wts;
  for (int l = 0; l < kMaxLayers; ++l) {
    wts.w[l] = l < n_layers ? static_cast<const T*>(w[l]) : nullptr;
    wts.b[l] = l < n_layers ? static_cast<const T*>(b[l]) : nullptr;
  }
  void* k = kernel_of<T>(d_in, dim);
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  T* vp = static_cast<T*>(value);
  T* jp = static_cast<T*>(jac);
  T* hp = static_cast<T*>(hdiag);
  const dim3 grid(G), block(32 * P);
  switch (d_in * 4 + dim) {
    case 2 * 4 + 1: taylor_bundle_kernel<T, 2, 1><<<grid, block, smem, st>>>(xp, wts, net, n, P, vp, jp, hp); break;
    case 2 * 4 + 2: taylor_bundle_kernel<T, 2, 2><<<grid, block, smem, st>>>(xp, wts, net, n, P, vp, jp, hp); break;
    case 3 * 4 + 1: taylor_bundle_kernel<T, 3, 1><<<grid, block, smem, st>>>(xp, wts, net, n, P, vp, jp, hp); break;
    case 3 * 4 + 2: taylor_bundle_kernel<T, 3, 2><<<grid, block, smem, st>>>(xp, wts, net, n, P, vp, jp, hp); break;
    case 3 * 4 + 3: taylor_bundle_kernel<T, 3, 3><<<grid, block, smem, st>>>(xp, wts, net, n, P, vp, jp, hp); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch kernel 5 on `stream`; returns cudaGetLastError() after the launch.
// x (n, d_in); value (n, d_out), jac and hdiag (n, d_out, dim), row-major.
int taylor_bundle_f64(const void* x, const void* const* w, const void* const* b,
                      const int* widths, int n_layers, int d_in, int dim, int n,
                      int P, int G, int smem, void* value, void* jac,
                      void* hdiag, void* stream) {
  return launch_bundle<double>(x, w, b, widths, n_layers, d_in, dim, n, P, G,
                               smem, value, jac, hdiag, stream);
}

int taylor_bundle_f32(const void* x, const void* const* w, const void* const* b,
                      const int* widths, int n_layers, int d_in, int dim, int n,
                      int P, int G, int smem, void* value, void* jac,
                      void* hdiag, void* stream) {
  return launch_bundle<float>(x, w, b, widths, n_layers, d_in, dim, n, P, G,
                              smem, value, jac, hdiag, stream);
}

}  // extern "C"
