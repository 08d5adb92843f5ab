// Native Graph500 v2.1 deterministic Kronecker edge generator.
//
// The port's own copy of combblas_tpu/io/native/graphgen.cpp, unchanged
// but for this header. The reference's generator is native C
// (graph500-1.2/generator/, driven by RefGen21.h); this is the native twin
// of combblas_tpu_torch/utils/refgen21.py — identical MRG-over-Z_{2^31-1} stream,
// leapfrog skip matrices (recomputed at init), 4-way Bernoulli with exact
// rejection, clip-and-flip, and the multiplicative bit-reverse scramble.
// Bit-for-bit equal to the Python implementation (tested) and to the
// reference generator's output (the Python side carries the golden tests).
//
// C ABI (ctypes): cbtpu_graph500_edges(userseed, logN, start, end,
// src_out, dst_out, nthreads) — any sub-range of the global stream,
// threaded over edges (each edge's state is an O(log ei) skip from the
// seed, so threads are independent — the same property the reference's
// OpenMP loop exploits).
//
// Built at first use by combblas_tpu_torch/_build.py:build_host
// (g++ -O3 -std=c++17 -shared -fPIC -pthread) into build/combblas_tpu_torch/.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t P = 0x7FFFFFFFull;  // 2^31 - 1
constexpr uint64_t X = 107374182ull;
constexpr uint64_t Y = 104480ull;
constexpr int A_NUM = 5700;
constexpr int BC_NUM = 1900;
constexpr uint32_t DENOM = 10000;
constexpr uint32_t REJECT_LIMIT = 0xFFFFFFFFu % DENOM;  // 7295

inline uint64_t mod(uint64_t a) { return a % P; }
inline uint64_t mmul(uint64_t a, uint64_t b) { return (a * b) % P; }

struct Mat {
  uint64_t s, t, u, v, w, a, b, c, d;
  void cache() {
    a = mod(X * s + t);
    b = mod(X * a + u);
    c = mod(X * b + v);
    d = mod(X * c + w);
  }
};

Mat identity_mat() {
  Mat m{0, 0, 0, 0, 1, 0, 0, 0, 0};
  m.cache();
  return m;
}

Mat A_mat() {
  Mat m{0, 0, 0, 1, 0, 0, 0, 0, 0};
  m.cache();
  return m;
}

Mat mat_mul(const Mat& m, const Mat& n) {
  Mat r;
  r.s = mod(mmul(m.s, n.d) + mmul(m.t, n.c) + mmul(m.u, n.b) +
            mmul(m.v, n.a) + mmul(m.w, n.s));
  r.t = mod(mmul(mmul(m.s, n.s), Y) + mmul(m.t, n.w) + mmul(m.u, n.v) +
            mmul(m.v, n.u) + mmul(m.w, n.t));
  r.u = mod(mmul(mod(mmul(m.s, n.a) + mmul(m.t, n.s)), Y) + mmul(m.u, n.w) +
            mmul(m.v, n.v) + mmul(m.w, n.u));
  r.v = mod(mmul(mod(mmul(m.s, n.b) + mmul(m.t, n.a) + mmul(m.u, n.s)), Y) +
            mmul(m.v, n.w) + mmul(m.w, n.v));
  r.w = mod(mmul(mod(mmul(m.s, n.c) + mmul(m.t, n.b) + mmul(m.u, n.a) +
                     mmul(m.v, n.s)), Y) +
            mmul(m.w, n.w));
  r.cache();
  return r;
}

struct State {
  uint64_t z1, z2, z3, z4, z5;
};

inline void apply(const Mat& m, State& st) {
  uint64_t o1 = mod(mmul(m.d, st.z1) +
                    mmul(mod(mmul(m.s, st.z2) + mmul(m.a, st.z3) +
                             mmul(m.b, st.z4) + mmul(m.c, st.z5)),
                         Y));
  uint64_t o2 = mod(mod(mmul(m.c, st.z1) + mmul(m.w, st.z2)) +
                    mmul(mod(mmul(m.s, st.z3) + mmul(m.a, st.z4) +
                             mmul(m.b, st.z5)),
                         Y));
  uint64_t o3 = mod(mod(mmul(m.b, st.z1) + mmul(m.v, st.z2) +
                        mmul(m.w, st.z3)) +
                    mmul(mod(mmul(m.s, st.z4) + mmul(m.a, st.z5)), Y));
  uint64_t o4 = mod(mod(mmul(m.a, st.z1) + mmul(m.u, st.z2) +
                        mmul(m.v, st.z3) + mmul(m.w, st.z4)) +
                    mmul(mmul(m.s, st.z5), Y));
  uint64_t o5 = mod(mmul(m.s, st.z1) + mmul(m.t, st.z2) + mmul(m.u, st.z3) +
                    mmul(m.v, st.z4) + mmul(m.w, st.z5));
  st = {o1, o2, o3, o4, o5};
}

// skip table: A^(256^i * j), i < 24, j < 256
struct SkipTable {
  Mat m[24][256];
  SkipTable() {
    Mat base = A_mat();
    for (int i = 0; i < 24; ++i) {
      Mat cur = identity_mat();
      m[i][0] = cur;
      for (int j = 1; j < 256; ++j) {
        cur = mat_mul(cur, base);
        m[i][j] = cur;
      }
      base = mat_mul(cur, base);
    }
  }
};

const SkipTable& table() {
  static SkipTable t;
  return t;
}

inline void skip(State& st, uint64_t high, uint64_t middle, uint64_t low) {
  const SkipTable& tab = table();
  for (int bi = 0; low; ++bi, low >>= 8) {
    uint8_t v = low & 0xFF;
    if (v) apply(tab.m[bi][v], st);
  }
  for (int bi = 8; middle; ++bi, middle >>= 8) {
    uint8_t v = middle & 0xFF;
    if (v) apply(tab.m[bi][v], st);
  }
  for (int bi = 16; high; ++bi, high >>= 8) {
    uint8_t v = high & 0xFF;
    if (v) apply(tab.m[bi][v], st);
  }
}

inline uint32_t get_uint_orig(State& st) {
  uint64_t ne = mod(X * st.z1 + Y * st.z5);
  st = {ne, st.z1, st.z2, st.z3, st.z4};
  return (uint32_t)ne;
}

inline int bernoulli4(State& st) {
  uint32_t val = get_uint_orig(st);
  while (val < REJECT_LIMIT) val = get_uint_orig(st);
  val %= DENOM;
  if ((int)val < BC_NUM) return 1;
  val -= BC_NUM;
  if ((int)val < BC_NUM) return 2;
  val -= BC_NUM;
  if (val < (uint32_t)A_NUM) return 0;
  return 3;
}

inline uint64_t bitreverse(uint64_t x) {
  x = __builtin_bswap64(x);
  x = ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
  x = ((x >> 2) & 0x3333333333333333ull) | ((x & 0x3333333333333333ull) << 2);
  x = ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
  return x;
}

inline int64_t scramble(int64_t v0, int lgN, uint64_t val0, uint64_t val1) {
  uint64_t v = (uint64_t)v0;
  v += val0 + val1;
  v *= (val0 | 0x4519840211493211ull);
  v = bitreverse(v) >> (64 - lgN);
  v *= (val1 | 0x3050852102C843A5ull);
  v = bitreverse(v) >> (64 - lgN);
  return (int64_t)v;
}

}  // namespace

extern "C" int cbtpu_graph500_edges(uint64_t userseed, int logN,
                                    int64_t start_edge, int64_t end_edge,
                                    int64_t* src_out, int64_t* dst_out,
                                    int nthreads) {
  if (logN < 1 || logN > 48 || end_edge < start_edge) return 1;
  // make_mrg_seed(userseed, userseed)
  State seed;
  seed.z1 = (userseed & 0x3FFFFFFFull) + 1;
  seed.z2 = ((userseed >> 30) & 0x3FFFFFFFull) + 1;
  seed.z3 = (userseed & 0x3FFFFFFFull) + 1;
  seed.z4 = ((userseed >> 30) & 0x3FFFFFFFull) + 1;
  seed.z5 = ((userseed >> 60) << 4) + (userseed >> 60) + 1;

  // MakeScrambleValues
  State zs = seed;
  skip(zs, 50, 7, 0);
  uint64_t v0a = get_uint_orig(zs), v0b = get_uint_orig(zs);
  uint64_t v1a = get_uint_orig(zs), v1b = get_uint_orig(zs);
  uint64_t val0 = v0a * 0xFFFFFFFFull + v0b;
  uint64_t val1 = v1a * 0xFFFFFFFFull + v1b;

  int64_t total = end_edge - start_edge;
  if (nthreads < 1) nthreads = 1;
  int64_t chunk = (total + nthreads - 1) / nthreads;
  (void)table();  // build once before threading

  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; ++k) {
      int64_t ei = start_edge + k;
      State st = seed;
      skip(st, 0, (uint64_t)ei, 0);
      int64_t nverts = (int64_t)1 << logN;
      int64_t bs = 0, bt = 0;
      while (nverts > 1) {
        int sq = bernoulli4(st);
        int so = sq / 2, to = sq % 2;
        if (bs == bt && so > to) {
          int tmp = so;
          so = to;
          to = tmp;
        }
        nverts /= 2;
        bs += nverts * so;
        bt += nverts * to;
      }
      src_out[k] = scramble(bs, logN, val0, val1);
      dst_out[k] = scramble(bt, logN, val0, val1);
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < total ? lo + chunk : total;
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}
