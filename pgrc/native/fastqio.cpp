// FASTQ/line-format parsing and read-line writing (host IO fast path).
//
// Fills the readsset iterator role (readsset/iterator/ReadsSetIterator.cpp:
// 45-243) for constant-length reads: one pass over the whole buffer,
// emitting 2 matrices [n_reads, read_len]: symbol value codes (ACGTN ->
// 0..4, anything else -> 4) and raw quality bytes.
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline const uint8_t *find_nl(const uint8_t *p, const uint8_t *end) {
    return static_cast<const uint8_t *>(memchr(p, '\n', end - p));
}

struct Sym2Val {
    uint8_t t[256];
    Sym2Val() {
        memset(t, 4, sizeof(t));
        t['A'] = t['a'] = 0;
        t['C'] = t['c'] = 1;
        t['G'] = t['g'] = 2;
        t['T'] = t['t'] = 3;
    }
};
const Sym2Val SYM2VAL;

const uint8_t VAL2SYM[5] = {'A', 'C', 'G', 'T', 'N'};

}  // namespace

extern "C" {

// Parse FASTQ. Returns number of reads parsed, or a negative error:
// -1 malformed record, -2 read length mismatch (variable-length input),
// -3 more reads than max_reads.
// read_len: in/out — pass 0 to autodetect from the first record.
int64_t fastq_parse(const uint8_t *buf, int64_t n, int64_t max_reads,
                    int64_t *read_len_io, uint8_t *codes, uint8_t *quality) {
    const uint8_t *p = buf;
    const uint8_t *end = buf + n;
    int64_t L = *read_len_io;
    int64_t count = 0;
    while (p < end) {
        if (*p != '@') return -1;
        const uint8_t *nl = find_nl(p, end);
        if (!nl) return -1;
        p = nl + 1;                              // sequence line
        nl = find_nl(p, end);
        if (!nl) return -1;
        const int64_t len = nl - p;
        if (L == 0) L = len;
        else if (len != L) return -2;
        if (count >= max_reads) return -3;
        uint8_t *crow = codes + count * L;
        for (int64_t i = 0; i < len; i++) crow[i] = SYM2VAL.t[p[i]];
        p = nl + 1;                              // '+' line
        nl = find_nl(p, end);
        if (!nl || *p != '+') return -1;
        p = nl + 1;                              // quality line
        nl = find_nl(p, end);
        const uint8_t *qend = nl ? nl : end;
        if (qend - p != L) return -1;
        memcpy(quality + count * L, p, L);
        p = nl ? nl + 1 : end;
        count++;
    }
    *read_len_io = L;
    return count;
}

// Parse one-read-per-line input (also used for FASTA sequence lines
// pre-filtered by the caller). Same return conventions as fastq_parse.
int64_t lines_parse(const uint8_t *buf, int64_t n, int64_t max_reads,
                    int64_t *read_len_io, uint8_t *codes) {
    const uint8_t *p = buf;
    const uint8_t *end = buf + n;
    int64_t L = *read_len_io;
    int64_t count = 0;
    while (p < end) {
        const uint8_t *nl = find_nl(p, end);
        const uint8_t *e = nl ? nl : end;
        const int64_t len = e - p;
        if (len == 0) { p = e + 1; continue; }
        if (L == 0) L = len;
        else if (len != L) return -2;
        if (count >= max_reads) return -3;
        uint8_t *crow = codes + count * L;
        for (int64_t i = 0; i < len; i++) crow[i] = SYM2VAL.t[p[i]];
        p = nl ? nl + 1 : end;
        count++;
    }
    *read_len_io = L;
    return count;
}

// codes [n, L] -> ASCII read lines with trailing '\n' into out [n*(L+1)].
void reads_write_lines(const uint8_t *codes, int64_t n, int64_t L, uint8_t *out) {
    int64_t nthreads = (int64_t)std::thread::hardware_concurrency();
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 16) nthreads = 16;
    if (n < 65536) nthreads = 1;
    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t r = lo; r < hi; r++) {
            const uint8_t *src = codes + r * L;
            uint8_t *dst = out + r * (L + 1);
            for (int64_t i = 0; i < L; i++)
                dst[i] = VAL2SYM[src[i] > 4 ? 4 : src[i]];
            dst[L] = '\n';
        }
    };
    if (nthreads == 1) { work(0, n); return; }
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < nthreads; t++)
        ts.emplace_back(work, n * t / nthreads, n * (t + 1) / nthreads);
    for (auto &th : ts) th.join();
}

// Multithreaded FASTQ parse for constant-length reads.
//
// The reference streams records through a single-threaded iterator
// (readsset/iterator/ReadsSetIterator.cpp:45-116); next to device-side
// encode stages a single-threaded parse would dominate, so: phase 1 collects newline offsets in parallel
// byte ranges (memchr, ~GB/s/thread), phase 2 splits complete 4-line
// records across threads for LUT conversion + quality copy. Exact record
// framing comes from global line numbering — no '@' content sniffing.
// Same return conventions as fastq_parse.
int64_t fastq_parse_mt(const uint8_t *buf, int64_t n, int64_t max_reads,
                       int64_t *read_len_io, uint8_t *codes,
                       uint8_t *quality) {
    int64_t nthreads = (int64_t)std::thread::hardware_concurrency();
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 16) nthreads = 16;
    if (n < (4 << 20)) nthreads = 1;

    // phase 1: newline offsets per byte range
    std::vector<std::vector<int64_t>> nls((size_t)nthreads);
    {
        std::vector<std::thread> ts;
        for (int64_t t = 0; t < nthreads; t++) {
            int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
            ts.emplace_back([&, t, lo, hi]() {
                auto &v = nls[(size_t)t];
                v.reserve((size_t)((hi - lo) / 64 + 16));
                const uint8_t *p = buf + lo, *end = buf + hi;
                while (p < end) {
                    const uint8_t *nl = find_nl(p, end);
                    if (!nl) break;
                    v.push_back(nl - buf);
                    p = nl + 1;
                }
            });
        }
        for (auto &th : ts) th.join();
    }
    std::vector<int64_t> off;
    {
        size_t total = 0;
        for (auto &v : nls) total += v.size();
        off.reserve(total + 1);
        for (auto &v : nls) off.insert(off.end(), v.begin(), v.end());
    }
    bool trailing = n > 0 && buf[n - 1] != '\n';
    if (trailing) off.push_back(n);  // final unterminated line
    int64_t nlines = (int64_t)off.size();
    if (nlines % 4) return -1;
    int64_t count = nlines / 4;
    if (count > max_reads) return -3;
    if (count == 0) { return 0; }

    // probe read length from the first record
    int64_t L = *read_len_io;
    {
        int64_t s1 = off[0] + 1, e1 = off[1];
        if (L == 0) L = e1 - s1;
    }

    // phase 2: convert records in parallel
    std::atomic<int64_t> err{0};
    auto work = [&](int64_t rlo, int64_t rhi) {
        for (int64_t r = rlo; r < rhi; r++) {
            int64_t l0 = 4 * r;
            int64_t s0 = (l0 == 0) ? 0 : off[l0 - 1] + 1;
            int64_t s1 = off[l0] + 1, e1 = off[l0 + 1];
            int64_t s2 = off[l0 + 1] + 1;
            int64_t s3 = off[l0 + 2] + 1, e3 = off[l0 + 3];
            if (buf[s0] != '@' || buf[s2] != '+') { err = -1; return; }
            if (e1 - s1 != L) { err = -2; return; }
            if (e3 - s3 != L) { err = -1; return; }
            uint8_t *crow = codes + r * L;
            const uint8_t *p = buf + s1;
            for (int64_t i = 0; i < L; i++) crow[i] = SYM2VAL.t[p[i]];
            memcpy(quality + r * L, buf + s3, (size_t)L);
        }
    };
    if (nthreads == 1 || count < 65536) {
        work(0, count);
    } else {
        std::vector<std::thread> ts;
        for (int64_t t = 0; t < nthreads; t++)
            ts.emplace_back(work, count * t / nthreads,
                            count * (t + 1) / nthreads);
        for (auto &th : ts) th.join();
    }
    if (err.load()) return err.load();
    *read_len_io = L;
    return count;
}

// Multithreaded FASTQ parse + stage-1 division in one pass, writing INTO
// caller-preallocated arrays at a row offset (streamed windows append
// without any concatenate/copy — this host's memory bandwidth is the
// bottleneck, so every avoided full-matrix touch matters).
//
// Emits per read: codes row, hq flag (quality[qcol] > '#', the simplified
// classifier of DivisionReadsSetDecorators.cpp:30-38) and an N flag
// (computed while converting symbols — replaces a separate [n, L] scan).
// The full quality matrix is never materialized. Same return conventions
// as fastq_parse.
// `final` == 0 allows a trailing partial record: the function parses the
// complete records and reports the byte offset after the last one in
// *consumed (the caller carries the tail into its next window). With
// `final` != 0 an unterminated last line is accepted and the record count
// must divide evenly.
// row_stride: BYTES between consecutive output rows (L for a dense matrix,
// 2*L to write every second row of a pair-interleaved matrix directly).
// revcomp != 0 writes each read reverse-complemented (PE pair-file
// convention, RevComplPairReadsSetIterator role) — fused into the symbol
// conversion, no second pass over the matrix.
int64_t fastq_parse_div_mt(const uint8_t *buf, int64_t n, int64_t max_reads,
                           int64_t *read_len_io, int64_t qcol, int final_win,
                           int revcomp, int64_t row_stride,
                           uint8_t *codes, uint8_t *hq_flag,
                           uint8_t *n_flag, int64_t *consumed) {
    int64_t nthreads = (int64_t)std::thread::hardware_concurrency();
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 16) nthreads = 16;
    if (n < (4 << 20)) nthreads = 1;

    // phase 1: newline offsets per byte range
    std::vector<std::vector<int64_t>> nls((size_t)nthreads);
    {
        std::vector<std::thread> ts;
        for (int64_t t = 0; t < nthreads; t++) {
            int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
            ts.emplace_back([&, t, lo, hi]() {
                auto &v = nls[(size_t)t];
                v.reserve((size_t)((hi - lo) / 64 + 16));
                const uint8_t *p = buf + lo, *end = buf + hi;
                while (p < end) {
                    const uint8_t *nl = find_nl(p, end);
                    if (!nl) break;
                    v.push_back(nl - buf);
                    p = nl + 1;
                }
            });
        }
        for (auto &th : ts) th.join();
    }
    std::vector<int64_t> off;
    {
        size_t total = 0;
        for (auto &v : nls) total += v.size();
        off.reserve(total + 1);
        for (auto &v : nls) off.insert(off.end(), v.begin(), v.end());
    }
    if (final_win && n > 0 && buf[n - 1] != '\n') off.push_back(n);
    int64_t nlines = (int64_t)off.size();
    if (final_win && nlines % 4) return -1;
    int64_t count = nlines / 4;
    if (count > max_reads) return -3;
    *consumed = count ? off[4 * count - 1] + 1 : 0;
    if (*consumed > n) *consumed = n;
    if (count == 0) return 0;

    int64_t L = *read_len_io;
    if (L == 0) L = off[1] - (off[0] + 1);
    if (qcol < 0) qcol = 0;
    if (qcol >= L) qcol = L - 1;
    if (row_stride <= 0) row_stride = L;

    std::atomic<int64_t> err{0};
    auto work = [&](int64_t rlo, int64_t rhi) {
        for (int64_t r = rlo; r < rhi; r++) {
            int64_t l0 = 4 * r;
            int64_t s0 = (l0 == 0) ? 0 : off[l0 - 1] + 1;
            int64_t s1 = off[l0] + 1, e1 = off[l0 + 1];
            int64_t s2 = off[l0 + 1] + 1;
            int64_t s3 = off[l0 + 2] + 1, e3 = off[l0 + 3];
            if (buf[s0] != '@' || buf[s2] != '+') { err = -1; return; }
            if (e1 - s1 != L) { err = -2; return; }
            if (e3 - s3 != L) { err = -1; return; }
            uint8_t *crow = codes + r * row_stride;
            const uint8_t *p = buf + s1;
            uint8_t has_n = 0;
            if (revcomp) {
                for (int64_t i = 0; i < L; i++) {
                    uint8_t v = SYM2VAL.t[p[L - 1 - i]];
                    crow[i] = v < 4 ? (uint8_t)(3 - v) : (uint8_t)4;
                    has_n |= (uint8_t)(v >> 2);
                }
            } else {
                for (int64_t i = 0; i < L; i++) {
                    uint8_t v = SYM2VAL.t[p[i]];
                    crow[i] = v;
                    has_n |= (uint8_t)(v >> 2);  // v == 4 only for N
                }
            }
            n_flag[r] = has_n;
            hq_flag[r] = buf[s3 + qcol] > '#';
        }
    };
    if (nthreads == 1 || count < 65536) {
        work(0, count);
    } else {
        std::vector<std::thread> ts;
        for (int64_t t = 0; t < nthreads; t++)
            ts.emplace_back(work, count * t / nthreads,
                            count * (t + 1) / nthreads);
        for (auto &th : ts) th.join();
    }
    if (err.load()) return err.load();
    *read_len_io = L;
    return count;
}

}  // extern "C"
