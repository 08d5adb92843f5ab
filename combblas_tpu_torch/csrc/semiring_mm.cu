// Dense semiring matrix product C[i,j] = (+)_k a[i,k] (x) b[k,j] on Hopper.
//
// Replaces: combblas_tpu/ops/pallas_kernels.py:_semiring_mm_kernel (the
// Pallas kernel behind semiring_matmul / min_plus_matmul), for the kinds
// min_plus, max_plus, max_min and plus_times.
//
// Bound on an H100: the product takes 2*m*n*k operations outside the tensor
// cores (one (x) and one (+) per step; float32 has no fused add-min). At
// 8192^3 that is 1.1e12 operations, about 16.4 ms against the card's 67
// TFLOP/s float32 peak, while the bytes (two 256 MB inputs read once, one
// 256 MB output written once) take about 0.24 ms at 3.35 TB/s. The kernel
// is bound by operations. The 67 TFLOP/s peak counts a fused multiply-add
// as two operations, so only plus_times (one FFMA per step) can approach
// it; the tropical kinds issue two instructions per step, and the
// min/max instruction (FMNMX) may issue at half the FFMA rate, so their
// practical ceiling sits near twice the bound.
//
// Design against that bound (the first, simple version): each block of 256
// threads owns a 64x64 output tile and loops over k itself (the TPU kernel
// carried the sum across a sequential k grid instead, which blocks that run
// in no order cannot do). Per k-slice of 16, A (transposed) and B are staged
// in shared memory; each thread keeps a 4x4 accumulator tile in registers
// and reads one float4 of A and one of B per k step, so 16 semiring steps
// cost two shared loads. Ragged edges load the fold's identity, which is
// inert under the fold. The folds use min.NaN / max.NaN, which propagate a
// NaN as jnp.minimum / jnp.maximum do (fminf / fmaxf would drop it). Built
// without --use_fast_math: denormals are kept, so results stay bit-equal
// to the plain version. Faster variants (larger register tiles, cp.async or
// TMA double buffering, wgmma for plus_times) are later work.
//
// Interface: one extern "C" launcher per kind. Pointers are contiguous
// row-major float32 device buffers; the launcher allocates nothing and
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int PAD = 4;  // keeps float4 rows 16-byte aligned, spreads banks
constexpr int THREADS = 256;

enum Kind { MIN_PLUS = 0, MAX_PLUS = 1, MAX_MIN = 2, PLUS_TIMES = 3 };

__device__ __forceinline__ float min_nan(float x, float y) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

__device__ __forceinline__ float max_nan(float x, float y) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

template <int KIND>
struct Fold;

template <>
struct Fold<MIN_PLUS> {
  static __device__ __forceinline__ float identity() {
    return __int_as_float(0x7f800000);  // +inf
  }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    return min_nan(acc, __fadd_rn(a, b));
  }
};

template <>
struct Fold<MAX_PLUS> {
  static __device__ __forceinline__ float identity() {
    return __int_as_float(0xff800000);  // -inf
  }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    return max_nan(acc, __fadd_rn(a, b));
  }
};

template <>
struct Fold<MAX_MIN> {
  static __device__ __forceinline__ float identity() {
    return __int_as_float(0xff800000);  // -inf
  }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    return max_nan(acc, min_nan(a, b));
  }
};

template <>
struct Fold<PLUS_TIMES> {
  static __device__ __forceinline__ float identity() { return 0.0f; }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    return __fmaf_rn(a, b, acc);
  }
};

template <int KIND>
__global__ void __launch_bounds__(THREADS)
    semiring_mm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                       float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[BK][BM + PAD];  // A tile, transposed
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int t = threadIdx.x;
  const int tx = t % 16;  // 4 output columns each
  const int ty = t / 16;  // 4 output rows each
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const float ident = Fold<KIND>::identity();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = ident;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = t + i * THREADS;
      // A: 16 consecutive threads read 16 consecutive k of one row
      const int ar = idx / BK, ac = idx % BK;
      const int gr = m0 + ar, gk = k0 + ac;
      As[ac][ar] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : ident;
      // B: 64 consecutive threads read 64 consecutive columns of one row
      const int br = idx / BN, bc = idx % BN;
      const int gbk = k0 + br, gn = n0 + bc;
      Bs[br][bc] = (gbk < K && gn < N) ? B[(size_t)gbk * N + gn] : ident;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = Fold<KIND>::step(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) C[(size_t)row * N + col] = acc[i][j];
    }
  }
}

template <int KIND>
int launch(const float* a, const float* b, float* c, int m, int n, int k,
           cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  semiring_mm_kernel<KIND><<<grid, THREADS, 0, stream>>>(a, b, c, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int semiring_mm_min_plus(const float* a, const float* b, float* c, int m,
                         int n, int k, cudaStream_t stream) {
  return launch<MIN_PLUS>(a, b, c, m, n, k, stream);
}

int semiring_mm_max_plus(const float* a, const float* b, float* c, int m,
                         int n, int k, cudaStream_t stream) {
  return launch<MAX_PLUS>(a, b, c, m, n, k, stream);
}

int semiring_mm_max_min(const float* a, const float* b, float* c, int m,
                        int n, int k, cudaStream_t stream) {
  return launch<MAX_MIN>(a, b, c, m, n, k, stream);
}

int semiring_mm_plus_times(const float* a, const float* b, float* c, int m,
                           int n, int k, cudaStream_t stream) {
  return launch<PLUS_TIMES>(a, b, c, m, n, k, stream);
}

}  // extern "C"
