// Kernel 5: the Taylor bundle of a tanh MLP (sm_90a, plain C interface).
//
// Replaces the JAX package's `_kernel` (tpinn/pallas/mlp_bundle.py:235),
// launched by `mlp_taylor_bundle` (:1546).  For every point x (d_in columns)
// it writes the network's value (n, d_out), its Jacobian (n, d_out, dim) and
// its Hessian diagonal (n, d_out, dim) over input columns 0..dim-1,
// row-major, one after the other in one buffer.  S = 1 + 2·dim Taylor
// streams pass through the layers:
//   value   v' = tanh(z_v + b)
//   tangent g'_k = tanh'(z_v) z_gk                (input: the basis vector e_k)
//   second  h'_k = −2 v tanh' z_gk² + tanh' z_hk  (input: zero)
// and the head layer is linear, with the bias on the value stream only.
//
// Design: the tile design of kernels 1-4 (taylor_mlp.cuh), forward only.  A
// block of 256 threads walks tiles of P points.  A tile's streams form one
// matrix in shared memory with stream-major rows (row s·P + p); widths are
// padded to multiples of 8 with zero weights, so padded neurons carry exact
// zeros and the stream buffers are never zeroed.  Layer 0 is in closed form
// (value x·W0 + b0; the tangent rows are rows of W0; the second-order rows
// zero).  Every later layer is one phase of stream-grouped warp jobs
// (StreamTile: 8 points x 8 neurons x all S streams, float64 DMMA m16n8k8
// chains of two streams each that share W's operand; IEEE FFMA register
// tiles in float32, no TF32), followed in registers by the tanh-Taylor
// epilogue or, at the head, by the bias and a scatter of the tile's outputs
// into output order; consecutive threads then write the tile's three spans
// of value, jac and hdiag at consecutive addresses.  Forward only, the
// block needs two ping-pong stream buffers and no aux rows, cotangents or
// partials, so a 16-point float64 tile of 2-32-32-32-3 (69 KB) leaves room
// for two blocks per SM.  The weights are staged once per block by
// cp.async, and the next tile's points are prefetched during the current
// tile; a net whose padded weights do not fit beside a tile stages one
// layer's W at a time, double-buffered, the next layer's copy in flight
// during the current layer.  No reduction and no atomics: each point is
// independent, so two calls at the same parameters agree bit for bit
// whatever the grid.  What bounds it on the H100: operations (22,979 per
// point at 2-32-32-32-3, dim 2, against 136 bytes of input and output in
// float64).

#include "taylor_mlp.cuh"

namespace {

constexpr int kBundleThreads = 256;
constexpr int kBundleWarps = kBundleThreads / 32;
constexpr int kTwoBlockSmem = 113 * 1024;  // a block that leaves room for two per SM
constexpr int kBundleTiles[] = {32, 16, 8};  // points per tile

// Shared-memory layout of one block, in elements of T (mirrored by
// bundle_layout in tpinn_torch/kernels/mlp_bundle.py).  Every region starts
// at a multiple of four elements.
struct BundleLayout {
  int wp[kMaxLayers + 1];  // padded widths: wp[0] = d_in, wp[l] = pad8
  int ld[kMaxLayers + 1];  // row stride of a width-wp[l] matrix: wp + kSkew
  int w_off[kMaxLayers];   // W_l: wp[l] rows of stride ld[l+1] (streamed: W_0 only)
  int b_off[kMaxLayers];   // b_l: wp[l+1]
  int slot[2];             // streamed: two slots for the W_l of l >= 1
  int xb[2];               // two P x d_in input buffers (double-buffered)
  int act[2];              // two S·P x max ld stream buffers (ping-pong)
  int total;

  __host__ __device__ void build(const Net& net, int d_in, int dim, int P,
                                 bool streamed) {
    const int L = net.n_layers;
    const int S = 1 + 2 * dim;
    wp[0] = d_in;
    ld[0] = d_in;
    int ldm = 0;
    for (int l = 1; l <= L; ++l) {
      wp[l] = pad8(net.widths[l]);
      ld[l] = wp[l] + kSkew;
      if (ld[l] > ldm) ldm = ld[l];
    }
    int off = 0, wmax = 0;
    for (int l = 0; l < L; ++l) {
      const int size = wp[l] * ld[l + 1];
      w_off[l] = -1;
      if (l == 0 || !streamed) {
        w_off[l] = off;
        off += size;
      } else if (size > wmax) {
        wmax = size;
      }
    }
    for (int l = 0; l < L; ++l) {
      b_off[l] = off;
      off += wp[l + 1];
    }
    slot[0] = off;
    off += wmax;
    slot[1] = off;
    off += wmax;
    xb[0] = off;
    off += align4(P * d_in);
    xb[1] = off;
    off += align4(P * d_in);
    act[0] = off;
    off += S * P * ldm;
    act[1] = off;
    off += S * P * ldm;
    total = off;
  }
};

// W (wi x wo, dense in global memory) into a padded rows x cols matrix of
// row stride ldo: the entries by cp.async, zeros in the padding (the skew
// columns past cols are never read).
template <typename T>
__device__ void stage_w(T* dst, const T* src, int wi, int wo, int rows,
                        int cols, int ldo, int tid) {
  for (int q = tid; q < rows * cols; q += kBundleThreads) {
    const int i = q / cols, o = q % cols;
    if (i < wi && o < wo)
      cp_async<sizeof(T)>(dst + i * ldo + o, src + i * wo + o, true);
    else
      dst[i * ldo + o] = T(0);
  }
}

// A tile's points (P x D) into shared memory; rows at and past n read
// nothing and are zero.
template <typename T, int D>
__device__ void load_points(T* dst, const T* x, int tile, int P, int n, int tid) {
  for (int q = tid; q < P * D; q += kBundleThreads) {
    const size_t g = size_t(tile) * P * D + q;
    const bool ok = g < size_t(n) * D;
    cp_async<sizeof(T)>(dst + q, ok ? x + g : x, ok);
  }
}

// Where a tile's outputs sit in a stage buffer, in output order: the value
// (P x d_out), then jac and hdiag (P x d_out x DIM each).
template <int DIM>
struct Stage {
  int pd;  // P · d_out
  __device__ int value(int p, int o, int d_out) const { return p * d_out + o; }
  __device__ int jac(int p, int o, int k, int d_out) const {
    return pd + (p * d_out + o) * DIM + k;
  }
  __device__ int hdiag(int p, int o, int k, int d_out) const {
    return pd * (1 + DIM) + (p * d_out + o) * DIM + k;
  }
};

// Layer 0 of a net with hidden layers, in closed form: z_v = x·W0 + b0,
// z_gk = W0[k, :], z_hk = 0, then the tanh-Taylor rules into the stream
// matrix `out` (row stride ldo).
template <typename T, int D, int DIM>
__device__ void layer0_hidden(const T* xt, const T* W, const T* bias, int wo,
                              int ldo, int P, T* out, int tid) {
  const int ss = P * ldo;
  for (int q = tid; q < P * wo; q += kBundleThreads) {
    const int p = q / wo, o = q % wo;
    T zv = T(0);
#pragma unroll
    for (int i = 0; i < D; ++i) zv += xt[p * D + i] * W[i * ldo + o];
    const T v = tanh_t(zv + bias[o]);
    const T tp = T(1) - v * v;
    const T a = T(-2) * v * tp;
    T* e = out + p * ldo + o;
    e[0] = v;
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      const T zg = W[k * ldo + o];
      e[(1 + k) * ss] = tp * zg;
      e[(1 + DIM + k) * ss] = a * zg * zg;
    }
  }
}

// A one-layer net: layer 0 is the head, straight into the stage.
template <typename T, int D, int DIM>
__device__ void layer0_head(const T* xt, const T* W, const T* bias, int d_out,
                            int ldo, int P, T* st, int tid) {
  const Stage<DIM> sg{P * d_out};
  for (int q = tid; q < P * d_out; q += kBundleThreads) {
    const int p = q / d_out, o = q % d_out;
    T zv = T(0);
#pragma unroll
    for (int i = 0; i < D; ++i) zv += xt[p * D + i] * W[i * ldo + o];
    st[sg.value(p, o, d_out)] = zv + bias[o];
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      st[sg.jac(p, o, k, d_out)] = W[k * ldo + o];
      st[sg.hdiag(p, o, k, d_out)] = T(0);
    }
  }
}

// Layer l >= 1: per warp job (8 points x CT neurons) the products
// Z_s = A_s·W of all S streams, the bias on the value stream, then (HEAD)
// the outputs into the stage in output order, or the tanh-Taylor epilogue
// into the stream matrix `dst` (row stride ldo).
template <typename T, int DIM, bool HEAD>
__device__ void layer_jobs(const T* A, int ldi, const T* W, const T* bias,
                           int wi, int wo, int ldo, int P, int d_out, T* dst,
                           int warp, int lane) {
  using ST = StreamTile<T>;
  constexpr int S = 1 + 2 * DIM;
  const int nc = (wo + ST::CT - 1) / ST::CT;
  const int jobs = ((P + 7) / 8) * nc;
  const int ss = P * ldo;
  const Stage<DIM> sg{P * d_out};
  for (int j = warp; j < jobs; j += kBundleWarps) {
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
      if (HEAD) {
        if (o >= d_out) continue;
        dst[sg.value(p, o, d_out)] = c[0][v] + bias[o];
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          dst[sg.jac(p, o, k, d_out)] = c[1 + k][v];
          dst[sg.hdiag(p, o, k, d_out)] = c[1 + DIM + k][v];
        }
      } else {
        if (o >= wo) continue;
        const T v0 = tanh_t(c[0][v] + bias[o]);
        const T tp = T(1) - v0 * v0;
        const T a = T(-2) * v0 * tp;
        T* e = dst + p * ldo + o;
        e[0] = v0;
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          const T zg = c[1 + k][v];
          e[(1 + k) * ss] = tp * zg;
          e[(1 + DIM + k) * ss] = a * zg * zg + tp * c[1 + DIM + k][v];
        }
      }
    }
  }
}

// The tile's outputs from the stage to global memory: three contiguous
// spans (value rows, jac rows, hdiag rows of the tile's n_act points), each
// written by consecutive threads at consecutive addresses.
template <typename T, int DIM>
__device__ void store_tile(const T* st, T* out, int tile, int P, int n_act,
                           int n, int d_out, int tid) {
  const int pd = P * d_out, m = n_act * d_out;
  const size_t v0 = size_t(tile) * pd;
  T* gv = out + v0;
  T* gj = out + size_t(n) * d_out + v0 * DIM;
  T* gh = out + size_t(n) * d_out * (1 + DIM) + v0 * DIM;
  for (int q = tid; q < m; q += kBundleThreads) gv[q] = st[q];
  for (int q = tid; q < m * DIM; q += kBundleThreads) {
    gj[q] = st[pd + q];
    gh[q] = st[pd * (1 + DIM) + q];
  }
}

template <typename T, int D, int DIM>
__global__ void __launch_bounds__(kBundleThreads, 2)
taylor_bundle_kernel(const T* __restrict__ x, Weights<T> wts, Net net, int n,
                     int P, int streamed, T* __restrict__ out) {
  T* sm = reinterpret_cast<T*>(dynamic_smem());
  BundleLayout ly;
  ly.build(net, D, DIM, P, streamed != 0);
  const int L = net.n_layers;
  const int d_out = net.widths[L];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_tiles = (n + P - 1) / P;
  const int G = gridDim.x;

  // once per block: the resident weights and every bias (zero-padded), W_1
  // into the first slot when the weights are streamed, the first tile
  for (int l = 0; l < L; ++l) {
    if (ly.w_off[l] >= 0)
      stage_w(sm + ly.w_off[l], wts.w[l], net.widths[l], net.widths[l + 1],
              ly.wp[l], ly.wp[l + 1], ly.ld[l + 1], tid);
    for (int q = tid; q < ly.wp[l + 1]; q += kBundleThreads) {
      if (q < net.widths[l + 1])
        cp_async<sizeof(T)>(sm + ly.b_off[l] + q, wts.b[l] + q, true);
      else
        sm[ly.b_off[l] + q] = T(0);
    }
  }
  if (streamed && L > 1)
    stage_w(sm + ly.slot[0], wts.w[1], net.widths[1], net.widths[2], ly.wp[1],
            ly.wp[2], ly.ld[2], tid);
  if ((int)blockIdx.x < n_tiles)
    load_points<T, D>(sm + ly.xb[0], x, blockIdx.x, P, n, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  int buf = 0;   // input buffer of the current tile
  int cur = 1;   // stream buffer holding the last layer's output
  int slot = 0;  // streamed: the slot that holds the next W_l
  for (int tile = blockIdx.x; tile < n_tiles; tile += G, buf ^= 1) {
    // prefetch the block's next tile (waited for at the end of layer 0)
    const int next = tile + G;
    if (next < n_tiles)
      load_points<T, D>(sm + ly.xb[buf ^ 1], x, next, P, n, tid);
    cp_async_commit();
    const T* xt = sm + ly.xb[buf];
    // layer 0 writes the buffer that the last tile's stage is not in
    cur ^= 1;
    if (L == 1)
      layer0_head<T, D, DIM>(xt, sm + ly.w_off[0], sm + ly.b_off[0], d_out,
                             ly.ld[1], P, sm + ly.act[cur], tid);
    else
      layer0_hidden<T, D, DIM>(xt, sm + ly.w_off[0], sm + ly.b_off[0],
                               ly.wp[1], ly.ld[1], P, sm + ly.act[cur], tid);
    cp_async_wait<0>();
    __syncthreads();

    for (int l = 1; l < L; ++l) {
      const T* W = sm + ly.w_off[l];
      if (streamed) {
        // this layer's W is in `slot`; the next one (or the next tile's
        // W_1) goes into the other, whose last reader finished before the
        // barrier above
        W = sm + ly.slot[slot];
        const int nl = l + 1 < L ? l + 1 : 1;
        if (l + 1 < L || next < n_tiles)
          stage_w(sm + ly.slot[slot ^ 1], wts.w[nl], net.widths[nl],
                  net.widths[nl + 1], ly.wp[nl], ly.wp[nl + 1], ly.ld[nl + 1],
                  tid);
        cp_async_commit();
        slot ^= 1;
      }
      const T* A = sm + ly.act[cur];
      T* Z = sm + ly.act[cur ^ 1];
      if (l + 1 < L)
        layer_jobs<T, DIM, false>(A, ly.ld[l], W, sm + ly.b_off[l], ly.wp[l],
                                  ly.wp[l + 1], ly.ld[l + 1], P, d_out, Z,
                                  warp, lane);
      else
        layer_jobs<T, DIM, true>(A, ly.ld[l], W, sm + ly.b_off[l], ly.wp[l],
                                 ly.wp[l + 1], ly.ld[l + 1], P, d_out, Z, warp,
                                 lane);
      cur ^= 1;
      cp_async_wait<0>();
      __syncthreads();
    }
    // no barrier after the stores: the next tile's layer 0 writes the other
    // stream buffer, and this one only after that layer's barrier
    store_tile<T, DIM>(sm + ly.act[cur], out, tile, P, min(P, n - tile * P), n,
                       d_out, tid);
  }
  cp_async_wait<0>();
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
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  return make_net(widths, n_layers, d_in, widths[n_layers], net);
}

size_t bundle_bytes(const Net& net, int d_in, int dim, int P, bool streamed,
                    size_t elem) {
  BundleLayout ly;
  ly.build(net, d_in, dim, P, streamed);
  return size_t(ly.total) * elem;
}

// Points per tile and weight staging for one net (mirrored by bundle_plan
// in tpinn_torch/kernels/mlp_bundle.py): the largest tile whose block
// leaves room for two blocks per SM with the weights resident; else the
// largest whose block fits with the weights resident; else the largest
// with the weights streamed one layer at a time (an 8-point tile of any
// net of at most kMaxLayers layers of at most kMaxWidth fits that way).
// 0 when nothing fits.
int bundle_points(const Net& net, int d_in, int dim, size_t elem, bool* streamed) {
  for (int pass = 0; pass < 3; ++pass) {
    const bool st = pass == 2;
    const size_t budget = pass == 0 ? kTwoBlockSmem : kSmemLimit;
    for (int P : kBundleTiles) {
      if (bundle_bytes(net, d_in, dim, P, st, elem) <= budget) {
        *streamed = st;
        return P;
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Launch plan of one call shape: points per tile (P), whether the weights
// are streamed, grid size (G: one block per tile, at most the resident
// blocks) and dynamic shared memory bytes.  Lets the instance use all of a
// block's shared memory (once per instance and device).  Returns 0, or a
// cudaError_t / -1 when the net does not fit.
int taylor_bundle_plan(int f64, const int* widths, int n_layers, int d_in,
                       int dim, int n, int* P_out, int* G_out, int* smem_out,
                       int* streamed_out) {
  Net net;
  if (!bundle_net(widths, n_layers, d_in, dim, &net)) return -1;
  const size_t elem = f64 ? sizeof(double) : sizeof(float);
  void* k = f64 ? kernel_of<double>(d_in, dim) : kernel_of<float>(d_in, dim);
  if (k == nullptr) return -1;
  bool streamed = false;
  const int P = bundle_points(net, d_in, dim, elem, &streamed);
  if (P == 0) return -1;
  const size_t bytes = bundle_bytes(net, d_in, dim, P, streamed, elem);
  int rc = allow_smem(k);
  if (rc != 0) return rc;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k, kBundleThreads, bytes);
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
  *streamed_out = int(streamed);
  return 0;
}

}  // extern "C"

namespace {

template <typename T>
int launch_bundle(const void* x, const void* const* w, const void* const* b,
                  const int* widths, int n_layers, int d_in, int dim, int n,
                  int P, int G, int smem, int streamed, void* out,
                  void* stream) {
  Net net;
  if (!bundle_net(widths, n_layers, d_in, dim, &net) || P < 1 ||
      P > kBundleTiles[0] || G < 1)
    return int(cudaErrorInvalidValue);
  Weights<T> wts;
  for (int l = 0; l < kMaxLayers; ++l) {
    wts.w[l] = l < n_layers ? static_cast<const T*>(w[l]) : nullptr;
    wts.b[l] = l < n_layers ? static_cast<const T*>(b[l]) : nullptr;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const dim3 grid(G), block(kBundleThreads);
  switch (d_in * 4 + dim) {
    case 2 * 4 + 1: taylor_bundle_kernel<T, 2, 1><<<grid, block, smem, st>>>(xp, wts, net, n, P, streamed, op); break;
    case 2 * 4 + 2: taylor_bundle_kernel<T, 2, 2><<<grid, block, smem, st>>>(xp, wts, net, n, P, streamed, op); break;
    case 3 * 4 + 1: taylor_bundle_kernel<T, 3, 1><<<grid, block, smem, st>>>(xp, wts, net, n, P, streamed, op); break;
    case 3 * 4 + 2: taylor_bundle_kernel<T, 3, 2><<<grid, block, smem, st>>>(xp, wts, net, n, P, streamed, op); break;
    case 3 * 4 + 3: taylor_bundle_kernel<T, 3, 3><<<grid, block, smem, st>>>(xp, wts, net, n, P, streamed, op); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch kernel 5 on `stream` with a plan from taylor_bundle_plan; returns
// cudaGetLastError() after the launch.  x (n, d_in); out holds value
// (n, d_out), then jac and hdiag (n, d_out, dim each), row-major.
int taylor_bundle_f64(const void* x, const void* const* w, const void* const* b,
                      const int* widths, int n_layers, int d_in, int dim, int n,
                      int P, int G, int smem, int streamed, void* out,
                      void* stream) {
  return launch_bundle<double>(x, w, b, widths, n_layers, d_in, dim, n, P, G,
                               smem, streamed, out, stream);
}

int taylor_bundle_f32(const void* x, const void* const* w, const void* const* b,
                      const int* widths, int n_layers, int d_in, int dim, int n,
                      int P, int G, int smem, int streamed, void* out,
                      void* stream) {
  return launch_bundle<float>(x, w, b, widths, n_layers, d_in, dim, n, P, G,
                              smem, streamed, out, stream);
}

}  // extern "C"
