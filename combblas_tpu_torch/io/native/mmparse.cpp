// Native Matrix Market parser — the performance path of the port's I/O.
//
// The port's own copy of combblas_tpu/io/native/mmparse.cpp, with one
// addition: mm_parse_range, the body lines that start inside one byte range
// of the file (a process's share of a read over several processes, the
// reference's newline rule). Built at first use by combblas_tpu_torch/_build.py:
// build_host (g++ -O3 -std=c++17 -shared -fPIC -pthread) into
// build/combblas_tpu_torch/.
//
// Plays the role of the reference's C mmio + parallel text ingestion
// (src/mmio.c banner/size parsing; SpParHelper::FetchBatch byte-range
// splitting with line realignment, SpParHelper.h:110-111, used by
// SpParMat::ParallelReadMM, SpParMat.cpp:3980-4127).  Where the reference
// parallelizes across MPI ranks reading one shared file, a TPU host
// parallelizes across threads: the body is split into nthreads byte ranges,
// each realigned to the next newline, counted, then parsed in place.
//
// C ABI (ctypes-friendly), no Python headers needed.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Header {
    int64_t nrows = 0, ncols = 0, nnz = 0;
    bool pattern = false;   // no value column
    bool complex_ = false;  // two value columns (we keep the real part)
    bool integer_ = false;
    int sym = 0;            // 0 general, 1 symmetric, 2 skew, 3 hermitian
    int64_t body_offset = 0;
};

// Parse the banner + size line; returns 0 on success.
int parse_header(FILE* f, Header* h) {
    char line[4096];
    if (!fgets(line, sizeof line, f)) return 1;
    if (strncmp(line, "%%MatrixMarket", 14) != 0) return 2;
    std::string banner(line);
    for (auto& ch : banner) ch = (char)tolower((unsigned char)ch);
    if (banner.find("matrix") == std::string::npos) return 3;
    if (banner.find("coordinate") == std::string::npos) return 4;  // dense unsupported here
    h->pattern = banner.find("pattern") != std::string::npos;
    h->complex_ = banner.find("complex") != std::string::npos;
    h->integer_ = banner.find("integer") != std::string::npos;
    if (banner.find("skew-symmetric") != std::string::npos) h->sym = 2;
    else if (banner.find("symmetric") != std::string::npos) h->sym = 1;
    else if (banner.find("hermitian") != std::string::npos) h->sym = 3;
    // skip comment lines
    long pos;
    for (;;) {
        pos = ftell(f);
        if (!fgets(line, sizeof line, f)) return 5;
        if (line[0] != '%') break;
    }
    long long a, b, c;
    if (sscanf(line, "%lld %lld %lld", &a, &b, &c) != 3) return 6;
    h->nrows = a; h->ncols = b; h->nnz = c;
    h->body_offset = ftell(f);
    return 0;
}

// Parse one byte range [s, e) of the body buffer into out arrays starting at
// slot `slot`. Returns number of entries parsed.
int64_t parse_range(const char* buf, int64_t s, int64_t e, bool pattern,
                    int64_t* rows, int64_t* cols, double* vals,
                    int64_t slot, int64_t cap) {
    const char* p = buf + s;
    const char* end = buf + e;
    int64_t k = slot;
    while (p < end && k < cap) {
        // skip whitespace/newlines
        while (p < end && isspace((unsigned char)*p)) ++p;
        if (p >= end) break;
        char* q;
        long long r = strtoll(p, &q, 10);
        if (q == p) { while (p < end && *p != '\n') ++p; continue; }
        p = q;
        long long c = strtoll(p, &q, 10);
        if (q == p) { while (p < end && *p != '\n') ++p; continue; }
        p = q;
        double v = 1.0;
        if (!pattern) {
            v = strtod(p, &q);
            p = q;
        }
        // skip rest of line (imaginary part of complex, stray columns)
        while (p < end && *p != '\n') ++p;
        rows[k] = r - 1;  // MM is 1-based
        cols[k] = c - 1;
        vals[k] = v;
        ++k;
    }
    return k - slot;
}

}  // namespace

extern "C" {

// Returns 0 on success. out = [nrows, ncols, nnz, pattern, sym, integer].
int mm_header(const char* path, int64_t* out) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    Header h;
    int rc = parse_header(f, &h);
    fclose(f);
    if (rc) return rc;
    out[0] = h.nrows; out[1] = h.ncols; out[2] = h.nnz;
    out[3] = h.pattern ? 1 : 0; out[4] = h.sym; out[5] = h.integer_ ? 1 : 0;
    return 0;
}

// Parse `bodylen` bytes of body text in `buf` (NUL-terminated) with
// `nthreads` threads into caller-allocated arrays of capacity `cap`. Returns
// entries parsed, or -4 when they pass `cap`.
static int64_t parse_buffer(const char* data, int64_t bodylen, bool pattern, int64_t* rows,
                            int64_t* cols, double* vals, int64_t cap, int nthreads) {
    if (nthreads < 1) nthreads = 1;

    // Byte-range split with newline realignment (the FetchBatch scheme).
    std::vector<int64_t> starts(nthreads + 1);
    starts[0] = 0;
    starts[nthreads] = bodylen;
    for (int t = 1; t < nthreads; ++t) {
        int64_t guess = bodylen * t / nthreads;
        while (guess < bodylen && data[(size_t)guess] != '\n') ++guess;
        starts[t] = guess < bodylen ? guess + 1 : bodylen;
    }
    // Count entries (newline-terminated non-empty lines) per range so each
    // thread writes to a disjoint slice.
    std::vector<int64_t> counts(nthreads, 0);
    {
        std::vector<std::thread> th;
        for (int t = 0; t < nthreads; ++t) {
            th.emplace_back([&, t] {
                int64_t n = 0;
                const char* p = data + starts[t];
                const char* end = data + starts[t + 1];
                while (p < end) {
                    while (p < end && isspace((unsigned char)*p)) ++p;
                    if (p >= end) break;
                    ++n;
                    while (p < end && *p != '\n') ++p;
                }
                counts[t] = n;
            });
        }
        for (auto& x : th) x.join();
    }
    std::vector<int64_t> offs(nthreads + 1, 0);
    for (int t = 0; t < nthreads; ++t) offs[t + 1] = offs[t] + counts[t];
    if (offs[nthreads] > cap) return -4;  // caller's buffer too small

    std::vector<int64_t> parsed(nthreads, 0);
    {
        std::vector<std::thread> th;
        for (int t = 0; t < nthreads; ++t) {
            th.emplace_back([&, t] {
                parsed[t] = parse_range(data, starts[t], starts[t + 1],
                                        pattern, rows, cols, vals, offs[t],
                                        offs[t] + counts[t]);
            });
        }
        for (auto& x : th) x.join();
    }
    int64_t total = 0;
    for (int t = 0; t < nthreads; ++t) total += parsed[t];
    // Compact if any range parsed fewer than counted (malformed lines).
    if (total != offs[nthreads]) {
        int64_t w = 0;
        for (int t = 0; t < nthreads; ++t) {
            int64_t s = offs[t];
            for (int64_t k = 0; k < parsed[t]; ++k, ++w) {
                rows[w] = rows[s + k];
                cols[w] = cols[s + k];
                vals[w] = vals[s + k];
            }
        }
    }
    return total;
}

// Parse the whole body with `nthreads` threads into caller-allocated arrays
// of capacity `cap`. Returns entries parsed, or negative on error.
int64_t mm_parse(const char* path, int64_t* rows, int64_t* cols, double* vals,
                 int64_t cap, int nthreads) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    Header h;
    if (parse_header(f, &h)) { fclose(f); return -2; }
    fseek(f, 0, SEEK_END);
    int64_t fsize = ftell(f);
    int64_t bodylen = fsize - h.body_offset;
    // +1 NUL terminator: strtoll/strtod are unbounded, so a final token with
    // no trailing newline must hit '\0', not run off the allocation.
    std::vector<char> buf((size_t)bodylen + 1, '\0');
    fseek(f, h.body_offset, SEEK_SET);
    if (bodylen > 0 &&
        fread(buf.data(), 1, (size_t)bodylen, f) != (size_t)bodylen) {
        fclose(f);
        return -3;
    }
    fclose(f);
    return parse_buffer(buf.data(), bodylen, h.pattern, rows, cols, vals, cap, nthreads);
}

// Parse the body lines that START in the file's byte range [lo, hi) (clamped
// to the body): a partial first line belongs to the range before, and the
// last line is read to its end past hi. Returns entries parsed, or negative
// on error (-4: more than `cap`).
int64_t mm_parse_range(const char* path, int64_t lo, int64_t hi, int64_t* rows,
                       int64_t* cols, double* vals, int64_t cap, int nthreads) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    Header h;
    if (parse_header(f, &h)) { fclose(f); return -2; }
    fseek(f, 0, SEEK_END);
    int64_t fsize = ftell(f);
    if (lo < h.body_offset) lo = h.body_offset;
    if (hi > fsize) hi = fsize;
    int64_t start = lo;
    if (lo > h.body_offset) {  // skip to the first line that starts at or after lo
        fseek(f, lo - 1, SEEK_SET);
        int c = fgetc(f);
        start = lo;
        while (c != EOF && c != '\n') { c = fgetc(f); ++start; }
        if (c == EOF) start = fsize;
    }
    if (start >= hi) { fclose(f); return 0; }
    int64_t stop = hi;  // the last line that starts before hi runs to its newline
    fseek(f, hi - 1, SEEK_SET);
    int c = fgetc(f);
    while (c != EOF && c != '\n') { c = fgetc(f); ++stop; }
    if (stop > fsize) stop = fsize;
    int64_t len = stop - start;
    std::vector<char> buf((size_t)len + 1, '\0');
    fseek(f, start, SEEK_SET);
    if (len > 0 && fread(buf.data(), 1, (size_t)len, f) != (size_t)len) {
        fclose(f);
        return -3;
    }
    fclose(f);
    return parse_buffer(buf.data(), len, h.pattern, rows, cols, vals, cap, nthreads);
}

}  // extern "C"
