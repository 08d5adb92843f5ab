// Dense -> sparse compaction of a flat row-major [R, 128] float32 view into
// (global flat index, value) pairs in row-major order, on Hopper.
//
// Replaces: combblas_tpu/ops/pallas_sparsify.py:_pack_kernel (the Pallas
// kernel behind flat_to_tuples_arrays / dense_to_sptuples). The output
// layout is the reference's, slot for slot (see ops/dense_to_tuples.py):
// panels of pr rows placed greedily at a running row offset, each written
// panel taking 8 * ceil(count / 1024) rows, its entries first and index -1
// / value `zero` after them; panels that do not fit are dropped whole.
//
// Bound on an H100: the work is one read of the input (4 bytes a cell) and
// one write of the output (8 bytes a slot); it does no arithmetic to speak
// of, so it is bound by bytes: (4*R*128 + 8*cap_slots) / 3.35 TB/s.
//
// Design against that bound (the first, simple version). The TPU kernel
// ranked and routed each panel through a butterfly of rolls, because the
// TPU has no scatter unit; a warp has ballot and popc, so ranks come from
// those and each entry is stored straight to its slot. Five launches on one
// stream:
//   count: one warp per 1024-cell tile (8 rows of 128; pr % 8 == 0, so a
//          tile never straddles two panels), 16-byte loads, a warp sum;
//   scan:  one block per panel, the exclusive prefix of its tile counts
//          and the panel total;
//   plan:  one block walks the panels in order (the greedy is sequential:
//          each offset depends on which earlier panels fit), 1024 panel
//          totals at a time through shared memory; writes each panel's row
//          offset (-1 when dropped), `total` and `end_row`;
//   write: one warp per tile of a written panel re-reads its cells and
//          stores each nonzero at off*128 + tile prefix + in-warp rank; the
//          panel's last tile also writes the panel's sentinel tail;
//   fill:  index -1 / value `zero` from end_row*128 to the end.
// Every output slot is stored once. The input is read twice (count and
// write); reading it once, with a decoupled look-back across tiles, is
// later work. The mask is the float compare x != zero (no fast math): -0.0
// equals 0.0, and NaN counts as a nonzero, as in the reference.
//
// Interface: one extern "C" launcher. `work` is an int32 scratch of
// 2*ntiles + 2*npanels + 2 entries (tile counts, tile prefixes, panel
// totals, panel offsets, total, end_row). The launcher allocates nothing
// and returns cudaGetLastError() after the last launch.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 1024;            // cells per tile: 8 rows of 128
constexpr int TILE_F4 = TILE / 4;     // float4 loads per tile
constexpr int WARPS_PER_BLOCK = 8;
constexpr int PLAN_THREADS = 1024;

__device__ __forceinline__ int rows_used8(int count) {
  return ((count + TILE - 1) / TILE) * 8;
}

__global__ void count_tiles(const float4* __restrict__ x, int ntiles, float zero,
                            int* __restrict__ tile_count) {
  const int tile = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (tile >= ntiles) return;  // whole warps leave together
  const float4* t = x + static_cast<size_t>(tile) * TILE_F4;
  int c = 0;
#pragma unroll
  for (int k = 0; k < TILE_F4 / 32; ++k) {
    const float4 v = __ldg(t + k * 32 + lane);
    c += (v.x != zero) + (v.y != zero) + (v.z != zero) + (v.w != zero);
  }
  c = __reduce_add_sync(FULL, c);
  if (lane == 0) tile_count[tile] = c;
}

// Exclusive prefix of the panel's tile counts, in chunks of blockDim.x.
__global__ void scan_panels(const int* __restrict__ tile_count, int tiles_per_panel,
                            int* __restrict__ tile_prefix, int* __restrict__ panel_total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t first = static_cast<size_t>(blockIdx.x) * tiles_per_panel;
  int carry = 0;
  for (int base = 0; base < tiles_per_panel; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < tiles_per_panel ? tile_count[first + i] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, w, o);
        if (lane >= o) w += y;
      }
      warp_sums[lane] = w;  // inclusive prefix of the warp sums
    }
    __syncthreads();
    const int warp_off = warp ? warp_sums[warp - 1] : 0;
    if (i < tiles_per_panel) tile_prefix[first + i] = carry + warp_off + incl - v;
    carry += warp_sums[nwarps - 1];
    __syncthreads();  // warp_sums is rewritten by the next chunk
  }
  if (threadIdx.x == 0) panel_total[blockIdx.x] = carry;
}

// The greedy placement: one thread walks the panel totals in order; the
// block stages them through shared memory 1024 at a time.
__global__ void plan_panels(const int* __restrict__ panel_total, int npanels, int cap_rows,
                            int* __restrict__ panel_off, int* __restrict__ scalars) {
  __shared__ int tot[PLAN_THREADS];
  __shared__ int offs[PLAN_THREADS];
  int off = 0;    // meaningful in thread 0 only
  int total = 0;  // likewise
  for (int base = 0; base < npanels; base += PLAN_THREADS) {
    const int n = min(PLAN_THREADS, npanels - base);
    if (threadIdx.x < n) tot[threadIdx.x] = panel_total[base + threadIdx.x];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 0; k < n; ++k) {
        const int tp = tot[k];
        const int used = rows_used8(tp);
        const bool fired = tp > 0 && static_cast<long long>(off) + used <= cap_rows;
        offs[k] = fired ? off : -1;
        off += fired ? used : 0;
        total += tp;
      }
    }
    __syncthreads();
    if (threadIdx.x < n) panel_off[base + threadIdx.x] = offs[threadIdx.x];
    __syncthreads();  // tot and offs are rewritten by the next chunk
  }
  if (threadIdx.x == 0) {
    scalars[0] = total;
    scalars[1] = off;
  }
}

__global__ void write_tiles(const float4* __restrict__ x, int ntiles, int tiles_per_panel,
                            float zero, const int* __restrict__ tile_count,
                            const int* __restrict__ tile_prefix,
                            const int* __restrict__ panel_total,
                            const int* __restrict__ panel_off, int* __restrict__ out_idx,
                            float* __restrict__ out_val) {
  const int tile = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (tile >= ntiles) return;
  const int panel = tile / tiles_per_panel;
  const int off = panel_off[panel];
  if (off < 0) return;  // dropped panel
  const long long panel_start = static_cast<long long>(off) * 128;
  if (tile_count[tile] > 0) {
    const float4* t = x + static_cast<size_t>(tile) * TILE_F4;
    const unsigned below = (1u << lane) - 1u;  // lanes before this one
    long long slot = panel_start + tile_prefix[tile];
    int gidx = tile * TILE + lane * 4;
#pragma unroll
    for (int k = 0; k < TILE_F4 / 32; ++k) {
      const float4 v = __ldg(t + k * 32 + lane);
      const bool m0 = v.x != zero, m1 = v.y != zero, m2 = v.z != zero, m3 = v.w != zero;
      const unsigned b0 = __ballot_sync(FULL, m0), b1 = __ballot_sync(FULL, m1);
      const unsigned b2 = __ballot_sync(FULL, m2), b3 = __ballot_sync(FULL, m3);
      long long s = slot + __popc(b0 & below) + __popc(b1 & below) + __popc(b2 & below) +
                    __popc(b3 & below);
      if (m0) { out_idx[s] = gidx;     out_val[s] = v.x; ++s; }
      if (m1) { out_idx[s] = gidx + 1; out_val[s] = v.y; ++s; }
      if (m2) { out_idx[s] = gidx + 2; out_val[s] = v.z; ++s; }
      if (m3) { out_idx[s] = gidx + 3; out_val[s] = v.w; }
      slot += __popc(b0) + __popc(b1) + __popc(b2) + __popc(b3);
      gidx += 128;
    }
  }
  if ((tile + 1) % tiles_per_panel == 0) {  // the panel's last tile: sentinel tail
    const int tp = panel_total[panel];
    const long long end = panel_start + static_cast<long long>(rows_used8(tp)) * 128;
    for (long long s = panel_start + tp + lane; s < end; s += 32) {
      out_idx[s] = -1;
      out_val[s] = zero;
    }
  }
}

// Slots from end_row*128 to the end: four at a time (both ends are
// multiples of 128, and torch's allocations are 16-byte aligned).
__global__ void fill_tail(const int* __restrict__ scalars, long long cap_slots, float zero,
                          int4* __restrict__ out_idx, float4* __restrict__ out_val) {
  const long long start = static_cast<long long>(scalars[1]) * 128 / 4;
  const long long stop = cap_slots / 4;
  const int4 ni = make_int4(-1, -1, -1, -1);
  const float4 nv = make_float4(zero, zero, zero, zero);
  for (long long s = start + blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       s < stop; s += static_cast<long long>(gridDim.x) * blockDim.x) {
    out_idx[s] = ni;
    out_val[s] = nv;
  }
}

}  // namespace

extern "C" int dense_to_tuples_f32(const float* x, int R, int pr, int cap_rows, float zero,
                                   int* work, int* out_idx, float* out_val, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = R / 8;
  const int npanels = R / pr;
  const int tiles_per_panel = pr / 8;
  int* tile_count = work;
  int* tile_prefix = tile_count + ntiles;
  int* panel_total = tile_prefix + ntiles;
  int* panel_off = panel_total + npanels;
  int* scalars = panel_off + npanels;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const int tile_blocks = (ntiles + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  count_tiles<<<tile_blocks, WARPS_PER_BLOCK * 32, 0, st>>>(x4, ntiles, zero, tile_count);
  const int scan_threads = std::min(1024, (tiles_per_panel + 31) / 32 * 32);
  scan_panels<<<npanels, scan_threads, 0, st>>>(tile_count, tiles_per_panel, tile_prefix,
                                                panel_total);
  plan_panels<<<1, PLAN_THREADS, 0, st>>>(panel_total, npanels, cap_rows, panel_off, scalars);
  write_tiles<<<tile_blocks, WARPS_PER_BLOCK * 32, 0, st>>>(
      x4, ntiles, tiles_per_panel, zero, tile_count, tile_prefix, panel_total, panel_off,
      out_idx, out_val);
  const long long cap_slots = static_cast<long long>(cap_rows) * 128;
  fill_tail<<<132 * 8, 256, 0, st>>>(scalars, cap_slots, zero, reinterpret_cast<int4*>(out_idx),
                                     reinterpret_cast<float4*>(out_val));
  return static_cast<int>(cudaGetLastError());
}
