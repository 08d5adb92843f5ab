// Dense semiring matrix product C[i,j] = (+)_k a[i,k] (x) b[k,j] on Hopper.
//
// Replaces: combblas_tpu/ops/pallas_kernels.py:_semiring_mm_kernel (the
// Pallas kernel behind semiring_matmul / min_plus_matmul), for the kinds
// min_plus, max_plus, max_min and plus_times.
//
// Bounds per kind at 8192^3 on an NVIDIA H100 80GB HBM3 (SXM: 132 SMs,
// four schedulers of 32 lanes each) at its 700 W limit and 1980 MHz:
// - Published peak: 2*m*n*k operations at 67 TFLOP/s float32 (the peak
//   counts an FFMA as two operations): 16.4 ms for every kind. The bytes
//   (two 256 MB inputs read once, one 256 MB output written once) take
//   0.24 ms, so the product is bound by operations.
// - Instruction issue: a scheduler issues one warp instruction a clock.
//   plus_times needs one FFMA per semiring step, the same 16.4 ms. The
//   tropical kinds need two, as float32 has no fused add-min: FADD + FMNMX
//   (min_plus, max_plus) or FMNMX + FMNMX (max_min), 32.9 ms. With the
//   rest of this kernel's main loop (1.14 and 2.15 instructions a step in
//   its machine code) the issue floors are 18.8 and 35.3 ms.
// - FMNMX issues at half the FADD rate on this card (max_min, with the
//   same instruction count as min_plus, runs 1.6 times as long), so
//   max_min's two FMNMX hold their 16-lane pipe four clocks per warp step:
//   65.7 ms, whatever the rest of the loop does.
// Measured times beside these floors are in PERF.md.
//
// Design against those bounds: the published peak is out of reach for the
// tropical kinds, so the kernel aims at the issue floors, where every
// instruction that is not a semiring step is overhead, and shared-memory
// loads are the largest part of it.
// - Each block of 256 threads owns a 128x128 output tile and loops over k
//   itself (the TPU kernel carried the sum across a sequential k grid,
//   which blocks that run in no order cannot do). Each thread keeps an 8x8
//   accumulator tile in registers, as two 4-wide strips 64 apart in each
//   dimension, so one k step is 4 LDS.128 for 64 semiring steps. A warp
//   covers 32x64 outputs (8 threads across, 4 down): each quarter-warp
//   reads one float4 of A (a broadcast) and 128 contiguous bytes of B, so
//   no shared load conflicts.
// - Slices of BK k-columns are double-buffered in shared memory with one
//   barrier per slice. The next slice's global loads (16 bytes each) are
//   issued before the current slice is computed: A's into registers,
//   stored transposed to the other buffer after the compute (row stride
//   132 floats, so that its 4-byte stores conflict at most two ways); B's
//   by cp.async straight into the other buffer (the tiled instantiation;
//   the edge one stages B in registers too). BK is 16, which beat 8 for
//   every kind on the card.
// - Tensor cores are not used: they have no tropical mode, and TF32 would
//   change plus_times' float32 results.
// Two instantiations share that code: the tiled one takes m and n that
// are multiples of 128, k a multiple of BK and 16-byte-aligned pointers
// (its launcher checks and refuses anything else); the edge one takes any
// shape and alignment, loads element by element and fills what lies past
// an edge with the fold's identity, which is inert under the fold.
//
// Arithmetic: one accumulator per output, k folded from 0 to K-1 in order
// (no split-K, no reassociation), so results do not depend on the tile
// shape and plus_times is the same FMA chain (__fmaf_rn) in both
// instantiations. The folds use min.NaN / max.NaN, which propagate a NaN
// as jnp.minimum / jnp.maximum do (fminf / fmaxf would drop it). Built
// without --use_fast_math: denormals are kept.
//
// Interface: one extern "C" launcher per kind and instantiation,
// semiring_mm_<kind> (tiled) and semiring_mm_<kind>_edge. Pointers are
// contiguous row-major float32 device buffers; the launcher allocates
// nothing and returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue when the tiled one is given what it does not take.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;               // block tile rows
constexpr int BN = 128;               // block tile columns
constexpr int BK = 16;                // k-slice depth
constexpr int THREADS = 256;          // 16 x 16 threads, 8 x 8 outputs each
constexpr int MIN_BLOCKS = 2;         // blocks an SM: 128 registers a thread
constexpr int A_LD = BM + 4;          // row stride of the transposed A slice
constexpr int A_VECS = BM * BK / 4 / THREADS;  // float4 of A per thread per slice
constexpr int B_VECS = BK * BN / 4 / THREADS;  // float4 of B per thread per slice
static_assert(BK % 8 == 0, "BK must be a multiple of 8");

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// Four consecutive cells of row r of a row-major rows x cols matrix from
// column c on, the fold's identity where they lie outside it.
__device__ __forceinline__ float4 load4_masked(const float* __restrict__ p, int r,
                                               int c, int rows, int cols,
                                               float ident) {
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = (r < rows && c + i < cols) ? p[(size_t)r * cols + c + i] : ident;
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <int KIND, bool EDGE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    semiring_mm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                       float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[2][BK][A_LD];  // A slices, transposed
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  // columns tx*4 + {0..3} and 64 + tx*4 + {0..3}; rows likewise with ty
  const int tx = (warp % 2) * 8 + lane % 8;
  const int ty = (warp / 2) * 4 + lane / 8;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const float ident = Fold<KIND>::identity();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = ident;

  // The next slice in flight: float4 v of A covers row idx / (BK/4), k
  // columns (idx % (BK/4)) * 4 + {0..3}; of B, k row idx / (BN/4),
  // columns (idx % (BN/4)) * 4 + {0..3}; idx = t + v * THREADS.
  // (pb only in the edge instantiation; the tiled one copies B by cp.async)
  float4 pa[A_VECS], pb[B_VECS];

  auto load = [&](int k0, int buf) {
#pragma unroll
    for (int v = 0; v < A_VECS; ++v) {
      const int idx = t + v * THREADS;
      const int r = m0 + idx / (BK / 4), k = k0 + (idx % (BK / 4)) * 4;
      if constexpr (EDGE)
        pa[v] = load4_masked(A, r, k, M, K, ident);
      else
        pa[v] = *reinterpret_cast<const float4*>(A + (size_t)r * K + k);
    }
#pragma unroll
    for (int v = 0; v < B_VECS; ++v) {
      const int idx = t + v * THREADS;
      const int k = k0 + idx / (BN / 4), c = n0 + (idx % (BN / 4)) * 4;
      if constexpr (EDGE)
        pb[v] = load4_masked(B, k, c, K, N, ident);
      else
        cp_async16(&Bs[buf][k - k0][c - n0], B + (size_t)k * N + c);
    }
  };

  auto store = [&](int buf) {
#pragma unroll
    for (int v = 0; v < A_VECS; ++v) {
      const int idx = t + v * THREADS;
      const int r = idx / (BK / 4), k = (idx % (BK / 4)) * 4;
      As[buf][k + 0][r] = pa[v].x;
      As[buf][k + 1][r] = pa[v].y;
      As[buf][k + 2][r] = pa[v].z;
      As[buf][k + 3][r] = pa[v].w;
    }
    if constexpr (EDGE) {
#pragma unroll
      for (int v = 0; v < B_VECS; ++v) {
        const int idx = t + v * THREADS;
        const int k = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
        *reinterpret_cast<float4*>(&Bs[buf][k][c]) = pb[v];
      }
    }
  };

  auto fragment = [&](int buf, int kk, float (&a)[8], float (&b)[8]) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
    a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
    a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
    b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w;
    b[4] = b1.x, b[5] = b1.y, b[6] = b1.z, b[7] = b1.w;
  };

  auto fold = [&](const float (&a)[8], const float (&b)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = Fold<KIND>::step(acc[i][j], a[i], b[j]);
  };

  auto compute = [&](int buf) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
      fragment(buf, kk, a, b);
      fold(a, b);
    }
  };

  const int nk = (K + BK - 1) / BK;
  if (nk > 0) {
    load(0, 0);
    store(0);
  }
  if constexpr (!EDGE) cp_async_wait_all();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) load((kt + 1) * BK, buf ^ 1);
    compute(buf);
    if (more) store(buf ^ 1);
    if constexpr (!EDGE) cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i / 4) * 64 + ty * 4 + i % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      if constexpr (EDGE) {
        if (row < M) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < N) C[(size_t)row * N + col + j] = acc[i][h * 4 + j];
        }
      } else {
        *reinterpret_cast<float4*>(C + (size_t)row * N + col) = make_float4(
            acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      }
    }
  }
}

template <int KIND, bool EDGE>
int launch(const float* a, const float* b, float* c, int m, int n, int k,
           cudaStream_t stream) {
  if (!EDGE) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(a) |
                           reinterpret_cast<uintptr_t>(b) |
                           reinterpret_cast<uintptr_t>(c);
    if (m % BM || n % BN || k % BK || addr % 16)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  semiring_mm_kernel<KIND, EDGE><<<grid, THREADS, 0, stream>>>(a, b, c, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int semiring_mm_min_plus(const float* a, const float* b, float* c, int m,
                         int n, int k, cudaStream_t stream) {
  return launch<MIN_PLUS, false>(a, b, c, m, n, k, stream);
}

int semiring_mm_max_plus(const float* a, const float* b, float* c, int m,
                         int n, int k, cudaStream_t stream) {
  return launch<MAX_PLUS, false>(a, b, c, m, n, k, stream);
}

int semiring_mm_max_min(const float* a, const float* b, float* c, int m,
                        int n, int k, cudaStream_t stream) {
  return launch<MAX_MIN, false>(a, b, c, m, n, k, stream);
}

int semiring_mm_plus_times(const float* a, const float* b, float* c, int m,
                           int n, int k, cudaStream_t stream) {
  return launch<PLUS_TIMES, false>(a, b, c, m, n, k, stream);
}

int semiring_mm_min_plus_edge(const float* a, const float* b, float* c, int m,
                              int n, int k, cudaStream_t stream) {
  return launch<MIN_PLUS, true>(a, b, c, m, n, k, stream);
}

int semiring_mm_max_plus_edge(const float* a, const float* b, float* c, int m,
                              int n, int k, cudaStream_t stream) {
  return launch<MAX_PLUS, true>(a, b, c, m, n, k, stream);
}

int semiring_mm_max_min_edge(const float* a, const float* b, float* c, int m,
                             int n, int k, cudaStream_t stream) {
  return launch<MAX_MIN, true>(a, b, c, m, n, k, stream);
}

int semiring_mm_plus_times_edge(const float* a, const float* b, float* c,
                                int m, int n, int k, cudaStream_t stream) {
  return launch<PLUS_TIMES, true>(a, b, c, m, n, k, stream);
}

}  // extern "C"
