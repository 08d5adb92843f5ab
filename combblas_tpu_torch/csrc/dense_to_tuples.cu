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
// Design against that bound. The unit of work is a chunk of 8, 16, 32 or
// 64 rows (the largest that divides pr, so a chunk never straddles two
// panels), one block of 256 threads a chunk, taken from a ticket counter
// so that chunks start in order. A block copies its chunk into shared
// memory with 16-byte cp.async (32 KB at most: five blocks an SM keep 160
// KB of loads in flight) and counts it (a block reduce); where it stores,
// a block scan of per-slice counts (four 16-bit fields packed in a 64-bit
// word) gives every cell's rank. The stores are staged in shared memory at
// the entries' ranks, shifted by the run's first slot mod 4 so that shared
// and global quads line up (values over the input's own cells, two slices
// of 1024 cells at a time, the last slices first, so nothing unread is
// overwritten; indices in an 8 KB buffer), then stored as 16-byte quads,
// scalar stores only in the partial quads at each run's ends. The block
// that places a panel also stores the panel's sentinel tail, in quads;
// the slots from end_row*128 to the end are filled last, in quads. Every
// output slot is stored once.
//
// The greedy placement. Panel p is written at `off` iff total_p > 0 and
// off + used_p <= cap_rows, and only a written panel advances off: each
// offset depends on every earlier panel. A panel descriptor (64 bits:
// flag, "intact" bit, the row offset after the panel, the panel's own row
// offset or -1) is published first as an aggregate (used_p), then as
// inclusive. While every panel so far fits, off is the plain prefix sum of
// used_p, so the block that places panel p looks back over the earlier
// descriptors like a decoupled scan: if the inclusive one it reaches is
// intact (every nonempty panel up to it was written) and the sum S of it
// and the aggregates after it leaves room (S + used_p <= cap_rows), every
// panel in between fitted too (their prefixes are at most S), and p is
// written at S. Otherwise it waits for panel p-1's inclusive descriptor and
// applies the greedy rule exactly.
//
// Counting. A block publishes its chunk's count in the chunk's status
// word and adds it, with a done mark, to its panel's counter (one 64-bit
// atomic: chunks done above bit 40, their sum below). The block whose add
// completes the panel knows the panel total; it places the panel and
// stores the panel's sentinel tail.
//
// Two instantiations.
//   single (compact_single + fill_tail): a block with entries to store
//     then waits for its panel's inclusive descriptor, sums the counts of
//     the panel's earlier chunks (all published by then) in one parallel
//     read, and stores from shared memory: one read of the input.
//   two_pass (count_chunks + scan_panels + write_chunks): the first kernel
//     counts and places as above and keeps nothing; the second scans each
//     written panel's chunk counts into prefixes; the third re-reads every
//     nonempty chunk of a written panel and stores it without waiting
//     (its extra blocks fill the tail). It reads the input twice.
// The wrapper picks (kernel_variant in ops/dense_to_tuples.py): single when
// a panel's chunks are no more than the blocks of compact_single the card
// holds at once, else two_pass.
//
// Termination. Every wait is for a panel descriptor. (a) Counting never
// waits, and chunks are taken in ticket order, so a panel's counter
// completes once the panel's last chunk has been taken. (b) The block that
// places panel p publishes p's aggregate before it waits; the aggregates
// and the inclusive descriptor of p-1 it may wait for are published by the
// blocks that complete earlier panels, whose chunks all have smaller
// tickets and which wait only on words of panels before theirs: by
// induction on p, every descriptor is published once p's last chunk has
// been taken. In two_pass that is all, for any pr: no block waits for a
// chunk with a larger ticket. (c) In single, a block of panel p also waits
// for p's descriptor, i.e. for p's last chunk to be taken. Let p be the
// first panel whose descriptor is not yet published. A block of an
// earlier panel waits for nothing unpublished and finishes; no block of a
// later panel exists, since its ticket would be larger than that of p's
// last chunk; so at most chunks_per_panel - 1 blocks wait, and if that is
// fewer than the blocks the card holds at once, a slot frees and the next
// ticket is taken, until p's last chunk is. The launcher refuses a single
// launch whose panels have more chunks than the card holds blocks of
// compact_single (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the
// SMs). Other kernels on the card can only delay it: their blocks end and
// free slots.
//
// The mask is the float compare x != zero (no fast math): -0.0 equals 0.0,
// and NaN counts as a nonzero, as in the reference.
//
// Interface: extern "C" launchers. `work` is an int32 scratch of
// 4 + 2*nchunks + 4*npanels entries (total, end_row, ticket, unused, then
// a 64-bit status word a chunk, a 64-bit descriptor and a 64-bit counter a
// panel); the launcher clears it on the stream, allocates nothing and
// returns cudaGetLastError() after the last launch.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLICE = THREADS * 4;                       // cells of one float4 a thread
constexpr int MAX_CHUNK_ROWS = 64;                       // mirrored in ops/dense_to_tuples.py
constexpr int MAX_SLICES = MAX_CHUNK_ROWS * 128 / SLICE;
constexpr int PACKS = MAX_SLICES / 4;                    // 64-bit words of four 16-bit counts
constexpr int GROUP = 2;                                 // slices staged at a time
constexpr u64 AGGREGATE = 1ull << 62;
constexpr u64 INCLUSIVE = 2ull << 62;
constexpr u64 INTACT = 1ull << 61;
constexpr u64 DONE = 1ull << 40;                         // a panel counter's chunks-done unit
constexpr int FILL_BLOCKS = 132 * 4;

__device__ __forceinline__ int rows_used8(int count) {
  return ((count + 1023) / 1024) * 8;
}

__device__ __forceinline__ unsigned flag(u64 w) { return static_cast<unsigned>(w >> 62); }
__device__ __forceinline__ int low(u64 w) { return static_cast<int>(static_cast<unsigned>(w)); }
__device__ __forceinline__ int offset_after(u64 desc) {
  return static_cast<int>((desc >> 32) & 0x1fffffffu);
}

__device__ __forceinline__ u64 load_volatile(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

__device__ __forceinline__ void store_volatile(u64* p, u64 v) {
  *reinterpret_cast<volatile u64*>(p) = v;
}

// The word at p once its flag is at least `least` (1: published, 2: inclusive).
__device__ u64 wait_flag(const u64* p, unsigned least) {
  u64 w;
  while (flag(w = load_volatile(p)) < least) __nanosleep(32);
  return w;
}

__device__ __forceinline__ int field(u64 packed, int k) {
  return static_cast<int>((packed >> (16 * (k & 3))) & 0xffffu);
}

__device__ __forceinline__ float component(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// A block's shared memory: about 41 KB, five blocks an SM.
struct Smem {
  float4 chunk[MAX_SLICES * THREADS + 1];  // the chunk; one float4 of slack for the staging shift
  int idx[GROUP * SLICE + 4];              // staged indices of one group
  u64 warp_tot[PACKS][WARPS];
  int warp_count[WARPS];
  int chunk_id, panel_total, off;  // panel_total: -1 unless this block completed the panel
};

// The block's Smem, in dynamic shared memory (it exceeds the 48 KB a
// static declaration may take).
__device__ __forceinline__ Smem& smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return *reinterpret_cast<Smem*>(smem_raw);
}

// A chunk's ranks: float4 k*THREADS + t of the chunk (slice k, thread t)
// holds cells in (k, t, component) order. `bits` has bit 4k+j for a nonzero
// component j of the thread's float4 in slice k; `packed[h]` holds the
// thread's counts of slices 4h..4h+3, 16 bits each, and `excl[h]` and
// `all[h]` the block's exclusive prefix and total of them (`scan_chunk`).
struct Ranks {
  u64 bits;
  u64 packed[PACKS];
  u64 excl[PACKS];
  u64 all[PACKS];
  int count;
  __device__ int slice_total(int k) const { return field(all[k >> 2], k); }
  __device__ int slice_excl(int k) const { return field(excl[k >> 2], k); }
};

__device__ __forceinline__ void load_chunk(const float4* __restrict__ x, int chunk, int slices,
                                           Smem& sm) {
  const float4* src = x + static_cast<size_t>(chunk) * slices * THREADS;
  for (int k = 0; k < slices; ++k) {
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(&sm.chunk[k * THREADS + threadIdx.x]));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src + k * THREADS + threadIdx.x));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The chunk's mask and its count (a block reduce): all a block needs
// before it publishes.
__device__ Ranks count_cells(int slices, float zero, Smem& sm) {
  const int tid = threadIdx.x;
  Ranks r;
  r.bits = 0;
  int c = 0;
#pragma unroll
  for (int h = 0; h < PACKS; ++h) r.packed[h] = 0;
#pragma unroll
  for (int k = 0; k < MAX_SLICES; ++k) {
    if (k < slices) {
      const float4 v = sm.chunk[k * THREADS + tid];
      const unsigned m = (v.x != zero) | (v.y != zero) << 1 | (v.z != zero) << 2 |
                         (v.w != zero) << 3;
      r.bits |= static_cast<u64>(m) << (4 * k);
      r.packed[k >> 2] |= static_cast<u64>(__popc(m)) << (16 * (k & 3));
      c += __popc(m);
    }
  }
  c = static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(c)));
  if ((tid & 31) == 0) sm.warp_count[tid >> 5] = c;
  __syncthreads();
  r.count = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) r.count += sm.warp_count[w];
  return r;
}

// The ranks: a block scan of the packed per-slice counts.
__device__ void scan_chunk(Ranks& r, Smem& sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  u64 incl[PACKS];
#pragma unroll
  for (int h = 0; h < PACKS; ++h) incl[h] = r.packed[h];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int h = 0; h < PACKS; ++h) {
      const u64 y = __shfl_up_sync(FULL, incl[h], o);
      if (lane >= o) incl[h] += y;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int h = 0; h < PACKS; ++h) sm.warp_tot[h][warp] = incl[h];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < PACKS; ++h) {
    u64 before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const u64 t = sm.warp_tot[h][w];
      before += w < warp ? t : 0;
      all += t;
    }
    r.excl[h] = before + incl[h] - r.packed[h];
    r.all[h] = all;
  }
}

// Index -1 / value `zero` into slots [start, end): this thread's share of
// `stride` threads, 16-byte stores between the partial quads at the ends.
__device__ void fill_range(int* __restrict__ out_idx, float* __restrict__ out_val,
                           long long start, long long end, float zero, long long t,
                           long long stride) {
  const long long up = (start + 3) & ~3LL, down = end & ~3LL;
  const long long a = up < end ? up : end;
  const long long b = down > a ? down : a;
  for (long long s = start + t; s < a; s += stride) { out_idx[s] = -1; out_val[s] = zero; }
  const int4 ni = make_int4(-1, -1, -1, -1);
  const float4 nv = make_float4(zero, zero, zero, zero);
  for (long long q = a / 4 + t; q < b / 4; q += stride) {
    reinterpret_cast<int4*>(out_idx)[q] = ni;
    reinterpret_cast<float4*>(out_val)[q] = nv;
  }
  for (long long s = b + t; s < end; s += stride) { out_idx[s] = -1; out_val[s] = zero; }
}

// The chunk's entries to slots [slot, slot + count), GROUP slices at a
// time, last group first. A group's values are staged over its own input
// cells (read into registers first; the shift of up to 3 slots runs into
// the next group's cells, already written, or the slack), its indices in
// sm.idx, both at (run start & 3) + rank, so that shared quad q is global
// quad q of the run's aligned start.
__device__ void write_chunk(const Ranks& r, int chunk, int slices, long long slot,
                            int* __restrict__ out_idx, float* __restrict__ out_val, Smem& sm) {
  const int tid = threadIdx.x;
  const int gbase = chunk * slices * SLICE;
  int before[MAX_SLICES + 1];
  before[0] = 0;
#pragma unroll
  for (int k = 0; k < MAX_SLICES; ++k)
    before[k + 1] = before[k] + (k < slices ? r.slice_total(k) : 0);
#pragma unroll
  for (int g = (MAX_SLICES + GROUP - 1) / GROUP - 1; g >= 0; --g) {
    const int k0 = g * GROUP;
    if (k0 >= slices) continue;
    const int k1 = k0 + GROUP < slices ? k0 + GROUP : slices;
    float4 v[GROUP];
#pragma unroll
    for (int i = 0; i < GROUP; ++i)
      if (k0 + i < k1) v[i] = sm.chunk[(k0 + i) * THREADS + tid];
    const long long run = slot + before[k0];
    const int shift = static_cast<int>(run & 3);
    const int n = shift + before[k1] - before[k0];
    float* s_val = reinterpret_cast<float*>(&sm.chunk[k0 * THREADS]);
    __syncthreads();  // the group's cells are read, the last group's stores are done
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      const int k = k0 + i;
      if (k >= k1) continue;
      int q = shift + before[k] - before[k0] + r.slice_excl(k);
      const int gi = gbase + k * SLICE + 4 * tid;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (r.bits >> (4 * k + j) & 1u) {
          sm.idx[q] = gi + j;
          s_val[q] = component(v[i], j);
          ++q;
        }
      }
    }
    __syncthreads();
    const long long q0 = (run - shift) / 4;
    for (int q = tid; q < (n + 3) / 4; q += THREADS) {
      const int s = 4 * q;
      if (s >= shift && s + 4 <= n) {
        reinterpret_cast<int4*>(out_idx)[q0 + q] = reinterpret_cast<const int4*>(sm.idx)[q];
        reinterpret_cast<float4*>(out_val)[q0 + q] = reinterpret_cast<const float4*>(s_val)[q];
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (s + m >= shift && s + m < n) {
            out_idx[4 * (q0 + q) + m] = sm.idx[s + m];
            out_val[4 * (q0 + q) + m] = s_val[s + m];
          }
        }
      }
    }
  }
}

// Places panel p with `tp` nonzeros (one warp of the block that completes
// the panel) and publishes its inclusive descriptor; returns its row
// offset, -1 when it is not written.
__device__ int place_panel(u64* desc, int p, int tp, int cap_rows) {
  const int lane = threadIdx.x & 31;
  const int used = rows_used8(tp);
  int start = 0;
  bool intact = true;  // every nonempty panel before p was written
  if (p > 0) {
    if (lane == 0) store_volatile(desc + p, AGGREGATE | static_cast<unsigned>(used));
    long long sum = 0;
    u64 found = 0;
    for (int j = p - 1;; j -= 32) {
      const int i = j - lane;
      const u64 w = i >= 0 ? wait_flag(desc + i, 1) : INCLUSIVE | INTACT;  // before panel 0
      const unsigned incl = __ballot_sync(FULL, flag(w) == 2);
      const int stop = incl ? __ffs(incl) - 1 : 32;
      sum += static_cast<long long>(
          __reduce_add_sync(FULL, lane < stop ? static_cast<unsigned>(w) : 0u));
      if (incl) {
        found = __shfl_sync(FULL, w, stop);
        break;
      }
    }
    sum += offset_after(found);
    if ((found & INTACT) && sum + used <= cap_rows) {
      start = static_cast<int>(sum);  // every panel in between was written too
    } else {
      const u64 prev = wait_flag(desc + p - 1, 2);  // the exact greedy step
      start = offset_after(prev);
      intact = (prev & INTACT) != 0;
    }
  }
  const bool fired = tp > 0 && static_cast<long long>(start) + used <= cap_rows;
  const int after = start + (fired ? used : 0);
  const int off = fired ? start : -1;
  __threadfence();  // the chunk counts this panel summed are visible before its descriptor
  if (lane == 0)
    store_volatile(desc + p, INCLUSIVE | (intact && (fired || tp == 0) ? INTACT : 0) |
                                 static_cast<u64>(after) << 32 | static_cast<unsigned>(off));
  return off;
}

// Places panel p with `tp` nonzeros and stores its sentinel tail: called
// by the whole block that completes the panel (warp 0 places it).
__device__ void place_and_seal(u64* desc, int p, int tp, int npanels, int cap_rows, float zero,
                               int* end_row, int* __restrict__ out_idx,
                               float* __restrict__ out_val, Smem& sm) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    const int off = place_panel(desc, p, tp, cap_rows);
    if (tid == 0) {
      if (p == npanels - 1) *end_row = offset_after(load_volatile(desc + p));
      sm.off = off;
    }
  }
  __syncthreads();
  if (sm.off >= 0) {
    const long long start = static_cast<long long>(sm.off) * 128;
    fill_range(out_idx, out_val, start + tp, start + static_cast<long long>(rows_used8(tp)) * 128,
               zero, tid, THREADS);
  }
}

__device__ __forceinline__ int take_ticket(unsigned* ticket, Smem& sm) {
  if (threadIdx.x == 0) sm.chunk_id = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  return sm.chunk_id;
}

// Loads and counts `chunk`, then publishes: the count goes to the chunk's status word and, with a done mark, into the
// panel's counter (one 64-bit atomic: chunks done above bit 40, their sum
// below); the block whose add completes the panel places it.
__device__ Ranks count_and_publish(const float4* __restrict__ x, int chunk, int slices,
                                   int chunks_per_panel, int npanels, int cap_rows, float zero,
                                   int* total, int* end_row, u64* status, u64* desc,
                                   u64* panel_count, int* __restrict__ out_idx,
                                   float* __restrict__ out_val, Smem& sm) {
  const int panel = chunk / chunks_per_panel;
  load_chunk(x, chunk, slices, sm);
  const Ranks r = count_cells(slices, zero, sm);
  if (threadIdx.x == 0) {
    store_volatile(status + chunk, AGGREGATE | static_cast<unsigned>(r.count));
    __threadfence();
    const u64 old = atomicAdd(panel_count + panel, DONE | static_cast<unsigned>(r.count));
    sm.panel_total = (old >> 40) + 1 == static_cast<u64>(chunks_per_panel)
                         ? static_cast<int>(old & (DONE - 1)) + r.count
                         : -1;
    if (r.count) atomicAdd(total, r.count);
  }
  __syncthreads();
  if (sm.panel_total >= 0)
    place_and_seal(desc, panel, sm.panel_total, npanels, cap_rows, zero, end_row, out_idx, out_val,
                   sm);
  return r;
}

// The row offset of `chunk`'s panel once placed (-1 when dropped), to
// every thread; then, for a written panel, the chunk's prefix in it: the
// sum of the counts of the panel's earlier chunks, all published by then,
// read in parallel.
__device__ int2 placed_prefix(int chunk, int chunks_per_panel, const u64* status,
                              const u64* desc, Smem& sm) {
  const int tid = threadIdx.x;
  const int first = chunk / chunks_per_panel * chunks_per_panel;
  __syncthreads();  // sm.off, sm.warp_tot are free
  if (tid == 0) {
    sm.off = low(wait_flag(desc + chunk / chunks_per_panel, 2));
    __threadfence();
  }
  __syncthreads();
  const int off = sm.off;
  if (off < 0) return make_int2(-1, 0);
  unsigned part = 0;
  for (int i = first + tid; i < chunk; i += THREADS) part += low(load_volatile(status + i));
  part = __reduce_add_sync(FULL, part);
  if ((tid & 31) == 0) sm.warp_tot[0][tid >> 5] = part;
  __syncthreads();
  int prefix = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) prefix += static_cast<int>(sm.warp_tot[0][w]);
  return make_int2(off, prefix);
}

// two_pass, first kernel: one chunk a block, counted and published.
__global__ void __launch_bounds__(THREADS)
    count_chunks(const float4* __restrict__ x, int slices, int chunks_per_panel, int npanels,
                 int cap_rows, float zero, int* total, int* end_row, unsigned* ticket,
                 u64* status, u64* desc, u64* panel_count, int* __restrict__ out_idx,
                 float* __restrict__ out_val) {
  Smem& sm = smem();
  const int chunk = take_ticket(ticket, sm);
  count_and_publish(x, chunk, slices, chunks_per_panel, npanels, cap_rows, zero, total, end_row,
                    status, desc, panel_count, out_idx, out_val, sm);
}

// two_pass, second kernel: one block a written panel; each chunk's status
// word becomes its exclusive prefix in the panel (above bit 32) beside its
// count (below).
__global__ void __launch_bounds__(THREADS)
    scan_panels(u64* status, const u64* desc, int chunks_per_panel) {
  __shared__ int warp_sums[WARPS];
  if (low(desc[blockIdx.x]) < 0) return;  // dropped (or empty) panel
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  u64* words = status + static_cast<size_t>(blockIdx.x) * chunks_per_panel;
  int carry = 0;
  for (int base = 0; base < chunks_per_panel; base += THREADS) {
    const int i = base + threadIdx.x;
    const int v = i < chunks_per_panel ? low(words[i]) : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int before = carry, all = carry;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      before += w < warp ? warp_sums[w] : 0;
      all += warp_sums[w];
    }
    if (i < chunks_per_panel)
      words[i] = static_cast<u64>(before + incl - v) << 32 | static_cast<unsigned>(v);
    carry = all;
    __syncthreads();  // warp_sums is rewritten by the next round
  }
}

// single: one chunk a block, kept in shared memory from its load to its
// stores; a block with entries to store waits for its panel's descriptor.
__global__ void __launch_bounds__(THREADS)
    compact_single(const float4* __restrict__ x, int slices, int chunks_per_panel, int npanels,
                   int cap_rows, float zero, int* total, int* end_row, unsigned* ticket,
                   u64* status, u64* desc, u64* panel_count, int* __restrict__ out_idx,
                   float* __restrict__ out_val) {
  Smem& sm = smem();
  const int chunk = take_ticket(ticket, sm);
  Ranks r = count_and_publish(x, chunk, slices, chunks_per_panel, npanels, cap_rows, zero, total,
                              end_row, status, desc, panel_count, out_idx, out_val, sm);
  if (r.count == 0) return;  // nothing to store
  scan_chunk(r, sm);
  const int2 op = placed_prefix(chunk, chunks_per_panel, status, desc, sm);
  if (op.x >= 0)
    write_chunk(r, chunk, slices, static_cast<long long>(op.x) * 128 + op.y, out_idx, out_val,
                sm);
}

// Slots from end_row*128 to the end (both multiples of 128).
__device__ __forceinline__ void fill_tail_part(const int* end_row, long long cap_slots,
                                               float zero, int* out_idx, float* out_val,
                                               int block, int nblocks) {
  fill_range(out_idx, out_val, static_cast<long long>(*end_row) * 128, cap_slots, zero,
             static_cast<long long>(block) * THREADS + threadIdx.x,
             static_cast<long long>(nblocks) * THREADS);
}

__global__ void __launch_bounds__(THREADS)
    fill_tail(const int* end_row, long long cap_slots, float zero, int* __restrict__ out_idx,
              float* __restrict__ out_val) {
  fill_tail_part(end_row, cap_slots, zero, out_idx, out_val, blockIdx.x, gridDim.x);
}

// two_pass, third kernel: re-reads and stores every nonempty chunk of a
// written panel (one block a chunk, at its panel's offset and its prefix),
// and fills the tail in the blocks past the chunks.
__global__ void __launch_bounds__(THREADS)
    write_chunks(const float4* __restrict__ x, int nchunks, int slices, int chunks_per_panel,
                 float zero, long long cap_slots, const int* end_row, const u64* status,
                 const u64* desc, int* __restrict__ out_idx, float* __restrict__ out_val) {
  Smem& sm = smem();
  if (static_cast<int>(blockIdx.x) >= nchunks) {
    fill_tail_part(end_row, cap_slots, zero, out_idx, out_val, blockIdx.x - nchunks,
                   gridDim.x - nchunks);
    return;
  }
  const int chunk = blockIdx.x;
  const int off = low(desc[chunk / chunks_per_panel]);
  const u64 word = status[chunk];
  if (off < 0 || low(word) == 0) return;  // dropped panel or empty chunk: not read again
  const int prefix = static_cast<int>(word >> 32);
  load_chunk(x, chunk, slices, sm);
  Ranks r = count_cells(slices, zero, sm);
  scan_chunk(r, sm);
  write_chunk(r, chunk, slices, static_cast<long long>(off) * 128 + prefix, out_idx, out_val,
              sm);
}

cudaError_t set_smem_limits() {
  const int bytes = sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(compact_single,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(count_chunks, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(write_chunks, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err;
}

// Blocks of compact_single the current device holds at once, read
// once per device (setting the kernels' shared-memory limits on the way).
int resident_blocks(int* out) {
  static int cached[64];  // 0: not read yet
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < 64 && cached[dev] > 0) {
    *out = cached[dev];
    return 0;
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = set_smem_limits();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compact_single, THREADS,
                                                        sizeof(Smem));
  *out = per_sm * sms;
  if (err == cudaSuccess && dev < 64) cached[dev] = *out;
  return static_cast<int>(err);
}

}  // namespace

// Blocks of the single-pass kernel the current device holds at once.
extern "C" int dense_to_tuples_resident_blocks(int* out) { return resident_blocks(out); }

// `single` != 0 picks the single-pass instantiation, which is refused
// (cudaErrorInvalidConfiguration, nothing launched) when a panel has more
// chunks than the device holds blocks at once; `chunk_rows` is 8, 16, 32
// or 64 and divides pr.
extern "C" int dense_to_tuples_f32(const float* x, int R, int pr, int chunk_rows, int cap_rows,
                                   float zero, int single, int* work, int* out_idx,
                                   float* out_val, void* stream) {
  if (pr <= 0 || R % pr || chunk_rows <= 0 || chunk_rows % 8 || chunk_rows > MAX_CHUNK_ROWS ||
      pr % chunk_rows || cap_rows < 0 || cap_rows >= (1 << 29))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nchunks = R / chunk_rows;
  const int npanels = R / pr;
  const int chunks_per_panel = pr / chunk_rows;
  const int slices = chunk_rows * 128 / SLICE;
  int resident = 0;
  cudaError_t err = static_cast<cudaError_t>(resident_blocks(&resident));  // also sets the limits
  if (err != cudaSuccess) return static_cast<int>(err);
  if (single && chunks_per_panel > resident)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  int* total = work;
  int* end_row = work + 1;
  unsigned* ticket = reinterpret_cast<unsigned*>(work + 2);
  u64* status = reinterpret_cast<u64*>(work + 4);
  u64* desc = status + nchunks;
  u64* panel_count = desc + npanels;
  err = cudaMemsetAsync(
      work, 0, (4 + 2 * static_cast<size_t>(nchunks) + 4 * static_cast<size_t>(npanels)) * 4, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const long long cap_slots = static_cast<long long>(cap_rows) * 128;
  if (single) {
    compact_single<<<nchunks, THREADS, sizeof(Smem), st>>>(
        x4, slices, chunks_per_panel, npanels, cap_rows, zero, total, end_row, ticket, status,
        desc, panel_count, out_idx, out_val);
    fill_tail<<<FILL_BLOCKS, THREADS, 0, st>>>(end_row, cap_slots, zero, out_idx, out_val);
  } else {
    count_chunks<<<nchunks, THREADS, sizeof(Smem), st>>>(
        x4, slices, chunks_per_panel, npanels, cap_rows, zero, total, end_row, ticket, status,
        desc, panel_count, out_idx, out_val);
    scan_panels<<<npanels, THREADS, 0, st>>>(status, desc, chunks_per_panel);
    write_chunks<<<nchunks + FILL_BLOCKS, THREADS, sizeof(Smem), st>>>(
        x4, nchunks, slices, chunks_per_panel, zero, cap_slots, end_row, status, desc, out_idx,
        out_val);
  }
  return static_cast<int>(cudaGetLastError());
}
