// Multithreaded CSV scanner for all-numeric tables: the host side of
// LOAD DATA INFILE.
//
// The port's copy of aquery2_tpu/native/csvscan.cpp (the JAX package's
// counterpart of the reference's vendored fast-cpp-csv-parser, csv.h),
// with the same design: one small shared library with a C ABI, called
// through ctypes; the whole file read once, split into per-thread chunks
// on line boundaries, parsed in parallel straight into the caller's
// column buffers (no realloc, no per-cell allocation). Cell types:
// i = int32, l = int64, f = float32, d = float64.
//
// What differs from the JAX package's copy: a cell either parses as SQL
// reads it or fails the load.
//   - Integers: an optional sign and decimal digits, range-checked for
//     the column's type (the JAX copy wraps an int32 overflow and reads
//     "1.5" as 1).
//   - Floats: decimal or exponent notation, inf, infinity and nan in any
//     case, with an optional sign, converted by strtod in the C locale
//     (correctly rounded; the JAX copy reads nan and inf as 0 and sums
//     digit by digit). A float32 cell is parsed as a double, then cast.
//   - Blanks (space, tab, CR) around a cell are ignored; an empty or
//     blank cell is SQL NULL: value 0 and validity 0.
//   - A line that is empty or blank is skipped, as np.loadtxt and the
//     line reader skip it (the JAX copy loads it as a row of NULLs).
//   - A line with fewer or more fields than columns fails the load (the
//     JAX copy fills NULLs or drops the extra fields).
// A failed cell makes aq_csv_parse return -3 and report the data row
// (0-based, after the skipped lines) and column of the first one.
//
// Build: g++ -O3 -fPIC -shared -pthread -std=c++17 (native/__init__.py
// does it at first use).
// ABI:
//   int64 aq_csv_count_rows(const char* data, int64 len, char sep,
//                           int skip);
//   int   aq_csv_parse(const char* data, int64 len, char sep, int skip,
//                      const char* colspec, int ncols, void** out_cols,
//                      uint8** out_valid, int64* null_counts, int64 nrows,
//                      int nthreads, int64* bad);
// Returns 0 on success, a negative code otherwise.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <locale.h>
#include <string>
#include <thread>
#include <vector>

namespace {

inline bool is_blank(char c) { return c == ' ' || c == '\t' || c == '\r'; }

inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

// The start of the line after the one p is in.
inline const char* next_line(const char* p, const char* end) {
    const void* nl = memchr(p, '\n', end - p);
    return nl ? static_cast<const char*>(nl) + 1 : end;
}

// A line of nothing but blanks (a blank separator is not one).
inline bool blank_line(const char* p, const char* end, char sep) {
    while (p < end && *p != '\n') {
        if (!is_blank(*p) || *p == sep) return false;
        ++p;
    }
    return true;
}

// Lines in [p, end) that hold anything but blanks (the data rows).
int64_t count_rows(const char* p, const char* end, char sep) {
    int64_t rows = 0;
    while (p < end) {
        if (!blank_line(p, end, sep)) ++rows;
        p = next_line(p, end);
    }
    return rows;
}

const char* skip_lines(const char* p, const char* end, int skip) {
    for (int s = 0; s < skip && p < end; ++s) p = next_line(p, end);
    return p;
}

// [b, e) as an integer in [lo, hi]: an optional sign, then digits.
bool parse_int(const char* b, const char* e, int64_t lo, int64_t hi,
               int64_t* out) {
    bool neg = false;
    if (b < e && (*b == '+' || *b == '-')) neg = *b++ == '-';
    if (b == e) return false;
    const uint64_t lim = neg ? static_cast<uint64_t>(-(lo + 1)) + 1
                             : static_cast<uint64_t>(hi);
    uint64_t v = 0;
    for (; b < e; ++b) {
        if (!is_digit(*b)) return false;
        const uint64_t d = static_cast<uint64_t>(*b - '0');
        if (v > (lim - d) / 10) return false;
        v = v * 10 + d;
    }
    *out = !neg ? static_cast<int64_t>(v)
                : v == 0 ? 0 : -static_cast<int64_t>(v - 1) - 1;
    return true;
}

bool same_word(const char* b, const char* e, const char* word) {
    const size_t n = strlen(word);
    if (static_cast<size_t>(e - b) != n) return false;
    for (size_t i = 0; i < n; ++i)
        if ((b[i] | 0x20) != word[i]) return false;
    return true;
}

locale_t c_locale() {
    static locale_t loc = newlocale(LC_NUMERIC_MASK, "C", nullptr);
    return loc;
}

// [b, e) as a double: [sign] (digits [. digits] | . digits)
// [(e|E) [sign] digits], or [sign] inf, infinity or nan in any case.
bool parse_f64(const char* b, const char* e, double* out) {
    const char* q = b;
    if (q < e && (*q == '+' || *q == '-')) ++q;
    if (!same_word(q, e, "inf") && !same_word(q, e, "infinity") &&
        !same_word(q, e, "nan")) {
        int digits = 0;
        while (q < e && is_digit(*q)) ++q, ++digits;
        if (q < e && *q == '.')
            for (++q; q < e && is_digit(*q); ++q) ++digits;
        if (digits == 0) return false;
        if (q < e && (*q == 'e' || *q == 'E')) {
            ++q;
            if (q < e && (*q == '+' || *q == '-')) ++q;
            int exp_digits = 0;
            while (q < e && is_digit(*q)) ++q, ++exp_digits;
            if (exp_digits == 0) return false;
        }
        if (q != e) return false;
    }
    const size_t n = e - b;
    char small[128];
    std::string big;
    const char* s = small;
    if (n < sizeof small) {
        memcpy(small, b, n);
        small[n] = '\0';
    } else {
        big.assign(b, e);
        s = big.c_str();
    }
    char* stop = nullptr;
    *out = strtod_l(s, &stop, c_locale());
    return stop == s + n;
}

struct ChunkJob {
    const char* begin;
    const char* end;       // at a line boundary
    int64_t row_offset;    // the data row index of the chunk's first row
};

// Parse a chunk's rows; on a bad cell or field count set *bad_row and
// *bad_col and return -3.
int parse_chunk(const ChunkJob& job, char sep, const char* colspec,
                int ncols, void** out_cols, uint8_t** out_valid,
                int64_t* null_counts, int64_t nrows, int64_t* bad_row,
                int* bad_col) {
    const char* p = job.begin;
    const char* end = job.end;
    int64_t row = job.row_offset;
    while (p < end) {
        if (blank_line(p, end, sep)) {
            p = next_line(p, end);
            continue;
        }
        if (row >= nrows) return -4;
        for (int c = 0; c < ncols; ++c) {
            const char* q = p;
            while (q < end && *q != sep && *q != '\n') ++q;
            const bool last = c + 1 == ncols;
            // a field must end at the separator, the last one at the
            // line's end
            if (last ? (q < end && *q == sep) : (q == end || *q != sep)) {
                *bad_row = row;
                *bad_col = c;
                return -3;
            }
            const char* b = p;
            const char* e = q;
            while (b < e && is_blank(*b)) ++b;
            while (e > b && is_blank(e[-1])) --e;
            const bool empty = b == e;
            if (empty && null_counts) null_counts[c]++;
            if (out_valid && out_valid[c]) out_valid[c][row] = !empty;
            bool ok = true;
            int64_t iv = 0;
            double dv = 0.0;
            switch (colspec[c]) {
                case 'i':
                    ok = empty || parse_int(b, e, INT32_MIN, INT32_MAX, &iv);
                    static_cast<int32_t*>(out_cols[c])[row] =
                        static_cast<int32_t>(iv);
                    break;
                case 'l':
                    ok = empty || parse_int(b, e, INT64_MIN, INT64_MAX, &iv);
                    static_cast<int64_t*>(out_cols[c])[row] = iv;
                    break;
                case 'f':
                    ok = empty || parse_f64(b, e, &dv);
                    static_cast<float*>(out_cols[c])[row] =
                        static_cast<float>(dv);
                    break;
                case 'd':
                    ok = empty || parse_f64(b, e, &dv);
                    static_cast<double*>(out_cols[c])[row] = dv;
                    break;
                default:
                    return -2;
            }
            if (!ok) {
                *bad_row = row;
                *bad_col = c;
                return -3;
            }
            p = q < end ? q + 1 : q;    // past the separator or newline
        }
        ++row;
    }
    return 0;
}

}  // namespace

extern "C" {

// Data rows after the first `skip` lines: the lines that are not blank.
int64_t aq_csv_count_rows(const char* data, int64_t len, char sep,
                          int skip) {
    return count_rows(skip_lines(data, data + len, skip), data + len, sep);
}

// out_valid: per-column uint8 validity buffers (may be NULL, or hold NULL
// entries): 1 = a value, 0 = an empty cell (SQL NULL). null_counts:
// per-column totals of empty cells (may be NULL). bad: int64[2], the data
// row and column of the first cell that failed (set where -3 returns).
int aq_csv_parse(const char* data, int64_t len, char sep, int skip,
                 const char* colspec, int ncols, void** out_cols,
                 uint8_t** out_valid, int64_t* null_counts, int64_t nrows,
                 int nthreads, int64_t* bad) {
    if (ncols <= 0 || nrows < 0) return -1;
    const char* end = data + len;
    const char* p = skip_lines(data, end, skip);
    if (nthreads < 1 || nrows < 65536) nthreads = 1;
    // split the body into nthreads chunks on line boundaries, and find
    // each chunk's first data row by counting the rows of those before it
    std::vector<const char*> starts(nthreads + 1);
    starts[0] = p;
    for (int t = 1; t < nthreads; ++t) {
        const char* q = p + ((end - p) * t) / nthreads;
        starts[t] = q > starts[t - 1] ? next_line(q - 1, end) : starts[t - 1];
    }
    starts[nthreads] = end;
    std::vector<int64_t> rows(nthreads, 0);
    {
        std::vector<std::thread> counters;
        for (int t = 0; t + 1 < nthreads; ++t)
            counters.emplace_back([&, t] {
                rows[t] = count_rows(starts[t], starts[t + 1], sep);
            });
        for (auto& th : counters) th.join();
    }
    std::vector<int64_t> offsets(nthreads, 0);
    for (int t = 1; t < nthreads; ++t) offsets[t] = offsets[t - 1] + rows[t - 1];
    std::vector<int> errs(nthreads, 0);
    std::vector<int64_t> bad_rows(nthreads, -1);
    std::vector<int> bad_cols(nthreads, -1);
    std::vector<std::vector<int64_t>> tnulls(
        nthreads, std::vector<int64_t>(ncols, 0));
    auto work = [&](int t) {
        ChunkJob job{starts[t], starts[t + 1], offsets[t]};
        errs[t] = parse_chunk(job, sep, colspec, ncols, out_cols, out_valid,
                              null_counts ? tnulls[t].data() : nullptr,
                              nrows, &bad_rows[t], &bad_cols[t]);
    };
    if (nthreads == 1) {
        work(0);
    } else {
        std::vector<std::thread> workers;
        for (int t = 0; t < nthreads; ++t) workers.emplace_back(work, t);
        for (auto& th : workers) th.join();
    }
    if (null_counts)
        for (int t = 0; t < nthreads; ++t)
            for (int c = 0; c < ncols; ++c) null_counts[c] += tnulls[t][c];
    for (int t = 0; t < nthreads; ++t)
        if (errs[t]) {
            if (bad) {
                bad[0] = bad_rows[t];
                bad[1] = bad_cols[t];
            }
            return errs[t];
        }
    return 0;
}

}  // extern "C"
