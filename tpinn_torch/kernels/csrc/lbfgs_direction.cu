// The L-BFGS direction in one launch for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the JAX package leaves optax.scale_by_lbfgs
// (its L-BFGS round in tpinn/optimize.py) to XLA, which fuses the two-loop
// recursion into a few device loops.  Op by op in PyTorch the same recursion
// is about 570 launches of 2-3 µs kernels an iteration (50 ring slots, a dot,
// a weight product and a float64 axpy per slot in each loop), and the host
// needs 15-19 µs to issue each one, so the card idles through the whole
// two-loop.  This kernel is all of optimize._scale_by_lbfgs on a CUDA vector:
// the newest pair stored at slot (count - 1) % m (zeros at count 0), its
// weight 1/<du, dw> (0 where that dot is 0), the identity scale
// <du, dw>/||du||^2 (min(1, 1/||g||) at count 0), the right loop from the
// newest slot to the oldest, the scaling, the left loop back, and the
// result written once, negated: the descent direction.
//
// What bounds it on this card: the chain of dependent passes, not the card's
// bandwidth.  At n = 2,307 parameters and m = 50 slots a call's least
// traffic is the 2(m - 1) older ring rows read, four vectors read and the
// pair and the direction written, 8 * n * (2m + 5) = 1.94 MB in float64
// (0.58 µs of DRAM time at 3.35 TB/s), but the recursion is 2m + 1
// passes, each needing the dot of the one before: every pass pulls two
// rows from L2 into the one SM that runs the block and ends in a
// block-wide reduction (a warp-shuffle tree, a barrier, a short serial
// sum).  The reductions alone take about 0.3-0.4 µs each on an H100
// (30-42 µs for the 100 of them with the passes' loads and arithmetic taken
// out); with them a call takes 84 µs at n = 921 and 106 µs at n = 2,307,
// about 0.8-1.05 µs a pass.
//
// Design: one block of 256 threads; thread t owns elements t, t + 256, ...
// of every vector, so the thread that stores a ring element is the one that
// reads it back (no hazard) and q, the vector the recursion carries, lives
// in the output buffer touched by its owner alone.  Each pass over the
// vector fuses one slot's axpy with the next slot's dot, so the recursion is
// 2m + 1 passes and 2m reductions (the first pass reduces three sums at
// once: <du, dw>, <du, du> or <g, g>, and the newest slot's <dw, g>).  A pass
// walks the vector in chunks of 2,560 elements (ten a thread: every net of
// the port's cases in one chunk), each chunk's loads issued together before
// its arithmetic.  Fewer warps make each reduction shorter: at n = 2,307
// on an H100 (one comparison, events around single calls), 256 threads took
// 119 µs a call, 512 took 132 and 1,024 about 217; 128 gained nothing and 64
// spilled registers.  Loading the next pass's
// rows into registers before the reduction (143 µs at 512 threads), or
// prefetching the ring into L2, did not pay.  Reductions take
// one barrier each (two buffers in turn) and add in a fixed order with no
// atomics: two calls at the same inputs agree bit for bit, and ranks of a
// point mesh holding the same vectors stay bit-equal.
//
// Arithmetic as PyTorch's op sequence does it: the differences, weight,
// scale and scaling in the vector's type; each dot rounded to the vector's
// type as torch.dot returns it, then a float64 coefficient (the weights are
// float64 whatever the vector's type); each axpy as a float64 product and a
// float64 sum rounded to the vector's type, with no fused multiply-add where
// PyTorch rounds twice.  The dots differ: every one sums in float64 in this
// kernel's fixed order.  In float64 only that order differs from cuBLAS's and
// the CPU's; a float32 dot, which cuBLAS and the CPU sum in float32, is also
// the more precise here, so float32 gaps to them come from precision too.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 10;                 // elements of a chunk per thread
constexpr int kChunk = kThreads * kPer;  // 2,560

template <typename T>
__device__ __forceinline__ T round_to(double v);
template <>
__device__ __forceinline__ float round_to<float>(double v) {
  return __double2float_rn(v);
}
template <>
__device__ __forceinline__ double round_to<double>(double v) {
  return v;
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

// One chunk of a pass, this thread's elements: q, the axpy's row a and the
// next dot's row b (zeros past n, or where there is no next dot).
template <typename T>
struct Tile {
  T q[kPer], a[kPer], b[kPer];
};

template <typename T>
__device__ __forceinline__ void load_tile(Tile<T>& t, const T* q, const T* a,
                                          const T* b, int base, int n) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = base + k * kThreads + threadIdx.x;
    const bool in = j < n;
    t.q[k] = in ? q[j] : T(0);
    t.a[k] = in ? a[j] : T(0);
    t.b[k] = in && b != nullptr ? b[j] : T(0);
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sums of K values a thread, the same bits in every thread: each
// warp's butterfly, then the warps' sums in warp order.  `red` holds two
// buffers used in turn, so that a buffer is written again only after the
// barrier of the next reduction, which every thread reaches after reading
// it: one barrier a reduction.
template <int K>
__device__ __forceinline__ void block_sum(double (&v)[K],
                                          double (*red)[K][kWarps],
                                          int& parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = warp_sum(v[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) red[parity][i][warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < K; ++i) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[parity][i][w];
    v[i] = s;
  }
  parity ^= 1;
}

// Step s of the recursion: s < m is the right loop from the newest slot
// back, s >= m the left loop from the oldest forward.  Its slot, its dot's
// row (s for the right loop, y for the left) and its axpy's row (the other).
struct Steps {
  int m, n, prev, mem;
  __device__ int slot(int s) const {
    return s < m ? (prev - s + m) % m : (mem + s - m) % m;
  }
  template <typename T>
  __device__ T* dot_row(int s, T* ring_s, T* ring_y) const {
    return (s < m ? ring_s : ring_y) + size_t(slot(s)) * n;
  }
  template <typename T>
  __device__ T* axpy_row(int s, T* ring_s, T* ring_y) const {
    return (s < m ? ring_y : ring_s) + size_t(slot(s)) * n;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    lbfgs_direction_kernel(const T* g, const T* x, const T* g_prev,
                           const T* x_prev, T* ring_s, T* ring_y,
                           double* weights, T* out, double* scale_out,
                           long long count, int m, int n) {
  extern __shared__ double tables[];  // weights [m], then the alphas [m]
  double* w = tables;
  double* alpha = tables + m;
  __shared__ double red1[2][1][kWarps];
  __shared__ double red3[2][3][kWarps];
  int parity1 = 0, parity3 = 0;
  const int tid = threadIdx.x;
  const Steps st{m, n, int((count + m - 1) % m), int(count % m)};
  const bool fresh = count == 0;

  for (int i = tid; i < m; i += kThreads) w[i] = weights[i];

  // pass 0: the newest pair into its slot, q = g, and three partial sums
  T* s_new = ring_s + size_t(st.prev) * n;
  T* y_new = ring_y + size_t(st.prev) * n;
  double sums[3] = {0.0, 0.0, 0.0};
  for (int j = tid; j < n; j += kThreads) {
    const T gj = g[j];
    const T dw = fresh ? T(0) : T(x[j] - x_prev[j]);
    const T du = fresh ? T(0) : T(gj - g_prev[j]);
    s_new[j] = dw;
    y_new[j] = du;
    out[j] = gj;
    sums[0] += double(du) * double(dw);
    sums[1] += fresh ? double(gj) * double(gj) : double(du) * double(du);
    sums[2] += double(dw) * double(gj);
  }
  block_sum<3>(sums, red3, parity3);

  T weight = T(0), scale;
  if (fresh) {
    const T r = div_rn(T(1), sqrt_rn(round_to<T>(sums[1])));
    scale = r > T(1) ? T(1) : r;  // NaN stays NaN, as torch.clamp_max
  } else {
    const T vdot = round_to<T>(sums[0]);
    const T den = round_to<T>(sums[1]);
    weight = vdot == T(0) ? T(0) : div_rn(T(1), vdot);
    scale = den > T(0) ? div_rn(vdot, den) : T(1);
  }
  const double w_new = double(weight);
  if (tid == 0) {
    weights[st.prev] = w_new;
    if (scale_out != nullptr) *scale_out = double(scale);
  }

  double dot = sums[2];
  for (int s = 0; s < 2 * m; ++s) {
    const int slot = st.slot(s);
    const double coef =
        __dmul_rn(slot == st.prev ? w_new : w[slot], double(round_to<T>(dot)));
    double c;
    if (s < m) {  // alpha = w <s, q>;  q <- q - alpha y
      c = -coef;
      if (tid == 0) alpha[slot] = coef;
    } else {  // beta = w <y, q>;  q <- q + (alpha - beta) s
      c = __dsub_rn(alpha[slot], coef);
    }
    const bool last = s == 2 * m - 1, scaled = s == m - 1;
    const T* a = st.axpy_row(s, ring_s, ring_y);
    const T* b = last ? nullptr : st.dot_row(s + 1, ring_s, ring_y);
    double part[1] = {0.0};
    for (int base = 0; base < n; base += kChunk) {
      Tile<T> t;
      load_tile(t, out, a, b, base, n);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int j = base + k * kThreads + tid;
        if (j < n) {
          T q = round_to<T>(__dadd_rn(double(t.q[k]), __dmul_rn(c, double(t.a[k]))));
          if (scaled) q = mul_rn(scale, q);
          if (last) {
            out[j] = -q;
          } else {
            out[j] = q;
            part[0] += double(t.b[k]) * double(q);
          }
        }
      }
    }
    if (last) break;
    block_sum<1>(part, red1, parity1);
    dot = part[0];
  }
}

template <typename T>
int launch(const void* g, const void* x, const void* g_prev, const void* x_prev,
           void* ring_s, void* ring_y, void* weights, void* out, void* scale_out,
           long long count, int m, int n, void* stream) {
  const size_t smem = 2 * size_t(m) * sizeof(double);
  lbfgs_direction_kernel<T><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const T*>(g_prev), static_cast<const T*>(x_prev),
      static_cast<T*>(ring_s), static_cast<T*>(ring_y),
      static_cast<double*>(weights), static_cast<T*>(out),
      static_cast<double*>(scale_out), count, m, n);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// The direction of optimize._scale_by_lbfgs for the gradient g at x: the
// pair (x - x_prev, g - g_prev) stored at ring row (count - 1) % m of
// ring_s / ring_y ((m, n), row-major) with its weight in weights (m float64),
// then the two-loop product written to out (n), negated: the descent
// direction.  scale_out (one float64, may be null) receives the identity
// scale.  x_prev
// and g_prev are not read at count 0.  Returns cudaGetLastError() after the
// launch.
int lbfgs_direction_f64(const void* g, const void* x, const void* g_prev,
                        const void* x_prev, void* ring_s, void* ring_y,
                        void* weights, void* out, void* scale_out,
                        long long count, int m, int n, void* stream) {
  return launch<double>(g, x, g_prev, x_prev, ring_s, ring_y, weights, out,
                        scale_out, count, m, n, stream);
}

int lbfgs_direction_f32(const void* g, const void* x, const void* g_prev,
                        const void* x_prev, void* ring_s, void* ring_y,
                        void* weights, void* out, void* scale_out,
                        long long count, int m, int n, void* stream) {
  return launch<float>(g, x, g_prev, x_prev, ring_s, ring_y, weights, out,
                       scale_out, count, m, n, stream);
}

}  // extern "C"
