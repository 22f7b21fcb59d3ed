// Roofline probe: bare kernels at the residual kernels' own shapes (sm_90a,
// plain C interface).
//
// Replaces the JAX package's TPU probe (scripts/roofline_probe.py, `run`
// :64, pallas_call :65), whose five Pallas bodies measure the attainable
// rate of one unit at the fused kernels' operand shapes.  Here each body is
// a kernel that does nothing else, at the port's precisions and tiles:
//
//   fwd      S independent chains a <- (W^T a)·1e-3 per stream, W (32, 32);
//            float64: warp jobs of 8 points x 8 columns x all S streams,
//            streams s and s+1 as the 16 rows of one DMMA m16n8k8 per 8 of
//            K, an odd S's last stream on two m8n8k4 (the residual kernels'
//            StreamTile); float32: 8 points x 16 columns of IEEE FFMA
//   gram     per stream g += a·a^T (the dW contraction over the tile's
//            points), a <- 0.999·a; out = broadcast(sum_s g_s[:, 0]) + 0·s;
//            float64: one 16 x 8 output tile per warp, S chains of DMMA
//            m16n8k8; float32: the same tile as IEEE FFMA
//   vpu      a <- a·b + 0.5 (one fused multiply-add), b the next stream
//   tanh     a <- tanh(a), the residual kernels' tanh_t
//   overlap  stream 0 the fwd chain, streams 1..S-1 the vpu chains, in one
//            block and one phase per rep
//
// Every tile is one block: S streams of 32 rows and C points (C the
// residual kernels' points per tile, 8, 16 or 32), (tiles, S, 32, C) in
// device memory, point-major stream matrices (row stride 36, as the
// residual kernels') in shared memory.  The dot chains pass through shared
// memory once per rep (ping-pong buffers, one block barrier), as a layer
// phase does; the elementwise chains stay in registers.  The 1e-3 and 0.999
// rescales keep the chains finite and make each rep's operands new, so
// nothing can be folded.  The reps loop is not unrolled, so the SASS of a
// float64 instance holds exactly one rep's DMMA and DFMA; the float32 loops
// over k (fwd) and points (gram) are left to nvcc's unrolling, so their
// SASS holds a whole number of steps, at most one rep's (all checked with
// cuobjdump).  What
// bounds each body is the unit it probes: nothing else runs, and a launch
// reads and writes its tiles once.

#include "ptx.cuh"

namespace {

constexpr int kW = 32;         // the probes' width
constexpr int kLd = kW + 4;    // row stride of a stream matrix in shared memory
constexpr int kElemThreads = 256;  // threads of an elementwise block

__device__ __forceinline__ float tanh_p(float v) { return tanhf(v); }
__device__ __forceinline__ double tanh_p(double v) { return tanh(v); }
__device__ __forceinline__ float fma_p(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_p(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// Columns of one dot job: 8 (float64 DMMA) or 16 (float32 FFMA).
template <typename T> struct DotJob { static constexpr int CT = 8; };
template <> struct DotJob<float> { static constexpr int CT = 16; };

template <typename T, int C>
__host__ __device__ constexpr int dot_jobs() { return (C / 8) * (kW / DotJob<T>::CT); }

// Load W (32 x 32, row-major [k][n]) and `ns` streams of one tile, stream
// s0 first, transposed into point-major rows A[s][p][k].
template <typename T, int C>
__device__ void stage(T* wm, T* a, const T* w, const T* tile, int s0, int ns) {
  for (int i = threadIdx.x; i < kW * kW; i += blockDim.x)
    wm[(i / kW) * kLd + i % kW] = w[i];
  for (int i = threadIdx.x; i < ns * kW * C; i += blockDim.x) {
    const int s = i / (kW * C), k = (i / C) % kW, p = i % C;
    a[(s * C + p) * kLd + k] = tile[((s0 + s) * kW + k) * C + p];
  }
}

// One dot job: z[s][p][n] = sum_k a[s][p][k] w[k][n] for the job's 8 points
// and CT columns, every stream, written scaled by 1e-3 to `out`.
template <typename T, int S, int C> struct Dot;

template <int S, int C> struct Dot<double, S, C> {
  __device__ static void run(const double* wm, const double* a, double* out,
                             int job, int lane) {
    const int p0 = (job / (kW / 8)) * 8, c0 = (job % (kW / 8)) * 8;
    const int g = lane >> 2, q = lane & 3;
    double c[S][2];
#pragma unroll
    for (int s = 0; s < S; ++s) c[s][0] = c[s][1] = 0.0;
    const double* ap = a + (p0 + g) * kLd + q;
    const double* bp = wm + q * kLd + c0 + g;
#pragma unroll
    for (int k = 0; k < kW; k += 8) {
      const double b0 = bp[k * kLd], b1 = bp[(k + 4) * kLd];
#pragma unroll
      for (int s = 0; s < S; s += 2) {
        const double* as = ap + s * C * kLd + k;
        if (s + 1 < S) {
          const double* at = as + C * kLd;
          dmma_16x8x8(c[s][0], c[s][1], c[s + 1][0], c[s + 1][1], as[0], at[0],
                      as[4], at[4], b0, b1);
        } else {
          dmma_8x8x4(c[s][0], c[s][1], as[0], b0, c[s][0], c[s][1]);
          dmma_8x8x4(c[s][0], c[s][1], as[4], b1, c[s][0], c[s][1]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int v = 0; v < 2; ++v)
        out[(s * C + p0 + g) * kLd + c0 + 2 * q + v] = c[s][v] * 1e-3;
  }
};

template <int S, int C> struct Dot<float, S, C> {
  __device__ static void run(const float* wm, const float* a, float* out,
                             int job, int lane) {
    const int p0 = (job / (kW / 16)) * 8, c0 = (job % (kW / 16)) * 16;
    const int p = p0 + (lane >> 2), cq = c0 + 4 * (lane & 3);
    float c[S][4];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[s][j] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < kW; ++k) {
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = wm[k * kLd + cq + j];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float av = a[(s * C + p) * kLd + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[s][j] = fmaf(av, bv[j], c[s][j]);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[(s * C + p) * kLd + cq + j] = c[s][j] * 1e-3f;
  }
};

template <typename T, int S, int C>
__device__ void store_streams(T* tile, const T* a, int s0, int ns) {
  for (int i = threadIdx.x; i < ns * kW * C; i += blockDim.x) {
    const int s = i / (kW * C), k = (i / C) % kW, p = i % C;
    tile[((s0 + s) * kW + k) * C + p] = a[(s * C + p) * kLd + k];
  }
}

// fwd: blockDim = 32 · dot_jobs, one job per warp and rep.
template <typename T, int S, int C>
__global__ void __launch_bounds__(512) fwd_kernel(const T* w, const T* in,
                                                  T* out, int reps) {
  T* sm = reinterpret_cast<T*>(dynamic_smem());
  T* wm = sm;
  T* buf[2] = {sm + kW * kLd, sm + kW * kLd + S * C * kLd};
  const size_t off = size_t(blockIdx.x) * S * kW * C;
  stage<T, C>(wm, buf[0], w, in + off, 0, S);
  __syncthreads();
  const int job = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    Dot<T, S, C>::run(wm, buf[r & 1], buf[(r + 1) & 1], job, lane);
    __syncthreads();
  }
  store_streams<T, S, C>(out + off, buf[reps & 1], 0, S);
}

// One 16 x 8 tile of g_s = a_s·a_s^T for every stream, accumulated in
// registers: lane (g, q) holds g_s(i0+g, j0+2q+v) in acc[s][v] and
// g_s(i0+g+8, j0+2q+v) in acc[s][2+v].
template <typename T, int S, int C> struct Gram;

template <int S, int C> struct Gram<double, S, C> {
  __device__ static void run(double (&acc)[S][4], const double* a, int i0,
                             int j0, int lane) {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const double* as = a + s * C * kLd;
#pragma unroll
      for (int k = 0; k < C; k += 8) {
        const double* r0 = as + (k + q) * kLd;
        const double* r1 = as + (k + q + 4) * kLd;
        dmma_16x8x8(acc[s][0], acc[s][1], acc[s][2], acc[s][3], r0[i0 + g],
                    r0[i0 + g + 8], r1[i0 + g], r1[i0 + g + 8], r0[j0 + g],
                    r1[j0 + g]);
      }
    }
  }
};

template <int S, int C> struct Gram<float, S, C> {
  __device__ static void run(float (&acc)[S][4], const float* a, int i0,
                             int j0, int lane) {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float* as = a + s * C * kLd;
#pragma unroll 4
      for (int p = 0; p < C; ++p) {
        const float* row = as + p * kLd;
        const float x0 = row[i0 + g], x1 = row[i0 + g + 8];
        const float y0 = row[j0 + 2 * q], y1 = row[j0 + 2 * q + 1];
        acc[s][0] = fmaf(x0, y0, acc[s][0]);
        acc[s][1] = fmaf(x0, y1, acc[s][1]);
        acc[s][2] = fmaf(x1, y0, acc[s][2]);
        acc[s][3] = fmaf(x1, y1, acc[s][3]);
      }
    }
  }
};

constexpr int kGramThreads = (kW / 16) * (kW / 8) * 32;  // one warp per tile of g

template <typename T, int S, int C>
__global__ void __launch_bounds__(kGramThreads) gram_kernel(const T* w,
                                                            const T* in,
                                                            T* out, int reps) {
  T* sm = reinterpret_cast<T*>(dynamic_smem());
  T* buf[2] = {sm + kW * kLd, sm + kW * kLd + S * C * kLd};
  T* col = sm;  // sum_s g_s[:, 0], after the reps
  const size_t off = size_t(blockIdx.x) * S * kW * C;
  stage<T, C>(sm, buf[0], w, in + off, 0, S);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = (warp / (kW / 8)) * 16, j0 = (warp % (kW / 8)) * 8;
  T acc[S][4];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[s][v] = T(0);
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    const T* a = buf[r & 1];
    T* nxt = buf[(r + 1) & 1];
    Gram<T, S, C>::run(acc, a, i0, j0, lane);
    for (int i = threadIdx.x; i < S * C * kLd; i += blockDim.x)
      nxt[i] = a[i] * T(0.999);
    __syncthreads();
  }
  if (j0 == 0 && (lane & 3) == 0) {  // the lanes holding column 0
    T s0 = acc[0][0], s1 = acc[0][2];
#pragma unroll
    for (int s = 1; s < S; ++s) {
      s0 = s0 + acc[s][0];
      s1 = s1 + acc[s][2];
    }
    col[i0 + (lane >> 2)] = s0;
    col[i0 + (lane >> 2) + 8] = s1;
  }
  __syncthreads();
  const T* src = in + off;
  T* dst = out + off;
  // col + 0·s rounded as two operations, as the JAX body's, never fused
  for (int i = threadIdx.x; i < S * kW * C; i += blockDim.x)
    dst[i] = add_rn(col[(i / C) % kW], mul_rn(src[i], T(0)));
}

// vpu and tanh: the S·32·C elements of a tile over 256 threads, each
// thread's E elements in registers for every rep.
template <typename T, int S, int C, bool TANH>
__global__ void __launch_bounds__(kElemThreads) elem_kernel(const T*,
                                                            const T* in,
                                                            T* out, int reps) {
  constexpr int N = S * kW * C, E = N / kElemThreads, WC = kW * C;
  static_assert(N % kElemThreads == 0, "whole elements per thread");
  const size_t off = size_t(blockIdx.x) * N;
  T a[E], b[E];
#pragma unroll
  for (int m = 0; m < E; ++m) {
    const int e = threadIdx.x + m * kElemThreads;
    a[m] = in[off + e];
    b[m] = TANH ? T(0) : in[off + ((e / WC + 1) % S) * WC + e % WC];
  }
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int m = 0; m < E; ++m)
      a[m] = TANH ? tanh_p(a[m]) : fma_p(a[m], b[m], T(0.5));
  }
#pragma unroll
  for (int m = 0; m < E; ++m) out[off + threadIdx.x + m * kElemThreads] = a[m];
}

// overlap: stream 0 the fwd chain (its dot jobs, one per warp), streams
// 1..S-1 the vpu chains spread over the same threads, in one phase per rep.
template <typename T, int S, int C>
__global__ void __launch_bounds__(512) overlap_kernel(const T* w, const T* in,
                                                      T* out, int reps) {
  constexpr int kThreads = 32 * dot_jobs<T, C>();
  constexpr int N = (S - 1) * kW * C, E = N / kThreads, WC = kW * C;
  static_assert(N % kThreads == 0, "whole elements per thread");
  T* sm = reinterpret_cast<T*>(dynamic_smem());
  T* buf[2] = {sm + kW * kLd, sm + kW * kLd + C * kLd};
  const size_t off = size_t(blockIdx.x) * S * WC;
  stage<T, C>(sm, buf[0], w, in + off, 0, 1);
  T a[E], b[E];
#pragma unroll
  for (int m = 0; m < E; ++m) {
    const int e = threadIdx.x + m * kThreads;  // within streams 1..S-1
    const int s = 1 + e / WC, sb = (s + 1) % S == 0 ? 1 : (s + 1) % S;
    a[m] = in[off + s * WC + e % WC];
    b[m] = in[off + sb * WC + e % WC];
  }
  __syncthreads();
  const int job = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    Dot<T, 1, C>::run(sm, buf[r & 1], buf[(r + 1) & 1], job, lane);
#pragma unroll
    for (int m = 0; m < E; ++m) a[m] = fma_p(a[m], b[m], T(0.5));
    __syncthreads();
  }
  store_streams<T, 1, C>(out + off, buf[reps & 1], 0, 1);
#pragma unroll
  for (int m = 0; m < E; ++m) out[off + WC + threadIdx.x + m * kThreads] = a[m];
}

template <typename T, int S, int C>
int launch_body(int body, const T* w, const T* in, T* out, int reps,
                int tiles, cudaStream_t st) {
  const size_t dot_smem = (kW * kLd + 2 * S * C * kLd) * sizeof(T);
  const size_t ovl_smem = (kW * kLd + 2 * C * kLd) * sizeof(T);
  void* k = nullptr;
  int threads = 0;
  size_t smem = 0;
  switch (body) {
    case 0: k = (void*)fwd_kernel<T, S, C>; threads = 32 * dot_jobs<T, C>(); smem = dot_smem; break;
    case 1: k = (void*)gram_kernel<T, S, C>; threads = kGramThreads; smem = dot_smem; break;
    case 2: k = (void*)elem_kernel<T, S, C, false>; threads = kElemThreads; break;
    case 3: k = (void*)elem_kernel<T, S, C, true>; threads = kElemThreads; break;
    case 4: k = (void*)overlap_kernel<T, S, C>; threads = 32 * dot_jobs<T, C>(); smem = ovl_smem; break;
    default: return int(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid(tiles), block(threads);
  switch (body) {
    case 0: fwd_kernel<T, S, C><<<grid, block, smem, st>>>(w, in, out, reps); break;
    case 1: gram_kernel<T, S, C><<<grid, block, smem, st>>>(w, in, out, reps); break;
    case 2: elem_kernel<T, S, C, false><<<grid, block, 0, st>>>(w, in, out, reps); break;
    case 3: elem_kernel<T, S, C, true><<<grid, block, 0, st>>>(w, in, out, reps); break;
    default: overlap_kernel<T, S, C><<<grid, block, smem, st>>>(w, in, out, reps); break;
  }
  return int(cudaGetLastError());
}

template <typename T, int S>
int launch_chunk(int body, int chunk, const T* w, const T* in, T* out,
                 int reps, int tiles, cudaStream_t st) {
  switch (chunk) {
    case 8: return launch_body<T, S, 8>(body, w, in, out, reps, tiles, st);
    case 16: return launch_body<T, S, 16>(body, w, in, out, reps, tiles, st);
    case 32: return launch_body<T, S, 32>(body, w, in, out, reps, tiles, st);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_probe(int body, int streams, int chunk, int reps, int tiles,
                 const void* w, const void* in, void* out, void* stream) {
  if (reps < 0 || tiles < 1) return int(cudaErrorInvalidValue);
  const T* wp = static_cast<const T*>(w);
  const T* ip = static_cast<const T*>(in);
  T* op = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (streams) {
    case 5: return launch_chunk<T, 5>(body, chunk, wp, ip, op, reps, tiles, st);
    case 6: return launch_chunk<T, 6>(body, chunk, wp, ip, op, reps, tiles, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// One launch of probe `body` (0 fwd, 1 gram, 2 vpu, 3 tanh, 4 overlap) on
// `stream`: `reps` reps on each of `tiles` tiles of (streams, 32, chunk)
// values, in (tiles, streams, 32, chunk) -> out of the same shape; w is
// (32, 32).  streams 5 or 6, chunk 8, 16 or 32.  Returns cudaGetLastError()
// after the launch.
int roofline_probe_f64(int body, int streams, int chunk, int reps, int tiles,
                       const void* w, const void* in, void* out, void* stream) {
  return launch_probe<double>(body, streams, chunk, reps, tiles, w, in, out,
                              stream);
}

int roofline_probe_f32(int body, int streams, int chunk, int reps, int tiles,
                       const void* w, const void* in, void* out, void* stream) {
  return launch_probe<float>(body, streams, chunk, reps, tiles, w, in, out,
                             stream);
}

}  // extern "C"
