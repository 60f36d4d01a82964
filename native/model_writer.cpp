// Native LIBSVM model writer: multi-threaded formatting + sequential write.
//
// The JAX framework's counterpart of the reference's OpenMP-parallel
// write_model (src/plssvm/csvm.cpp:60-204): each thread formats its slice of
// support-vector rows into a private buffer (the analog of the reference's
// thread-local fmt::memory_buffer, csvm.cpp:157-195), then the buffers are
// written to disk in order.  Consumed through ctypes
// (plssvm_sparse_fp22/io/native.py); the pure-Python writer remains the
// fallback and the byte-format oracle.
//
// Number formatting parity (csvm.cpp:144-154):
//   - alphas / rho use fmt::format("{}", double): shortest round-trip
//     digits, fixed notation for decimal exponents in [-4, 16), integral
//     values without a trailing ".0" — reproduced here from
//     std::to_chars(scientific) output (see fmt_shortest_double),
//   - feature values use fmt::format("{:e}") == printf "%e": 6 fractional
//     digits, two-digit exponent,
//   - zero-valued features are skipped; every SV line ends "value \n".

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Render `v` exactly like fmt::format("{}", v) / the Python writer's
// fmt_shortest (io/fmtlib.py): shortest round-trip digits; integers without
// a decimal point; scientific notation only for exponents < -4 or >= 16.
void fmt_shortest_double(std::string& out, double v) {
    if (std::isnan(v)) { out += "nan"; return; }
    if (std::isinf(v)) { out += (v > 0 ? "inf" : "-inf"); return; }
    if (v == 0.0) { out += '0'; return; }

    // shortest scientific form: [-]d[.ddd...]e±XX
    char buf[48];
    auto res = std::to_chars(buf, buf + sizeof buf, v, std::chars_format::scientific);
    const char* p = buf;
    bool neg = (*p == '-');
    if (neg) ++p;
    std::string digits;  // mantissa digits without the dot
    digits += *p++;
    if (*p == '.') {
        ++p;
        while (p < res.ptr && *p != 'e') digits += *p++;
    }
    int exp10 = 0;  // power of ten of the leading digit
    if (p < res.ptr && *p == 'e') {
        ++p;
        if (*p == '+') ++p;  // from_chars rejects an explicit plus sign
        std::from_chars(p, res.ptr, exp10);
    }

    if (neg) out += '-';

    bool integral = (v == std::trunc(v)) && (std::fabs(v) < 1e16);
    if (integral) {
        // digits zero-padded to exp10+1 places (e.g. 1e15 -> 1000000000000000)
        out += digits;
        out.append(static_cast<size_t>(exp10 + 1) - digits.size(), '0');
    } else if (exp10 >= -4 && exp10 < 16) {
        if (exp10 >= 0) {
            size_t ip = static_cast<size_t>(exp10) + 1;  // integer-part digits
            if (digits.size() <= ip) {
                out += digits;
                out.append(ip - digits.size(), '0');
            } else {
                out.append(digits, 0, ip);
                out += '.';
                out.append(digits, ip, std::string::npos);
            }
        } else {
            out += "0.";
            out.append(static_cast<size_t>(-exp10) - 1, '0');
            out += digits;
        }
    } else {
        out += digits[0];
        if (digits.size() > 1) {
            out += '.';
            out.append(digits, 1, std::string::npos);
        }
        out += 'e';
        out += (exp10 < 0 ? '-' : '+');
        char eb[16];
        std::snprintf(eb, sizeof eb, "%02d", exp10 < 0 ? -exp10 : exp10);
        out += eb;
    }
}

void format_rows(const int64_t* indptr, const int32_t* indices,
                 const double* values, const double* alphas,
                 const int64_t* order, size_t begin, size_t end,
                 std::string* out) {
    char pair[64];
    for (size_t r = begin; r < end; ++r) {
        int64_t row = order[r];
        fmt_shortest_double(*out, alphas[row]);
        *out += ' ';
        for (int64_t k = indptr[row]; k < indptr[row + 1]; ++k) {
            if (values[k] == 0.0) continue;  // zero features skipped (csvm.cpp:147)
            // "{idx}:{value:e} " via to_chars (printf-%e-compatible, but
            // much faster than snprintf)
            char* q = pair;
            q = std::to_chars(q, pair + sizeof pair, indices[k]).ptr;
            *q++ = ':';
            q = std::to_chars(q, pair + sizeof pair, values[k],
                              std::chars_format::scientific, 6).ptr;
            *q++ = ' ';
            out->append(pair, static_cast<size_t>(q - pair));
        }
        *out += '\n';
    }
}

}  // namespace

extern "C" {

// Write a LIBSVM model file: `header` verbatim, then the CSR rows selected
// by `order` (positives first, then negatives — caller-sorted).  Returns 0
// on success, nonzero with a message in err.
int plssvm_native_write_model(
    const char* path, const char* header,
    const int64_t* indptr, const int32_t* indices, const double* values,
    const double* alphas, const int64_t* order, int64_t n_rows,
    char* err, size_t err_len) {
    size_t n = static_cast<size_t>(n_rows);
    unsigned hw = std::thread::hardware_concurrency();
    size_t n_threads = std::max<size_t>(1, std::min<size_t>(hw ? hw : 1, n ? n : 1));
    std::vector<std::string> buffers(n_threads);
    {
        std::vector<std::thread> threads;
        size_t chunk = (n + n_threads - 1) / n_threads;
        for (size_t t = 0; t < n_threads; ++t) {
            size_t b = t * chunk;
            size_t e = std::min(n, b + chunk);
            if (b >= e) break;
            threads.emplace_back(format_rows, indptr, indices, values, alphas,
                                 order, b, e, &buffers[t]);
        }
        for (auto& th : threads) th.join();
    }

    std::FILE* f = std::fopen(path, "wb");
    if (!f) {
        std::snprintf(err, err_len, "Couldn't open file '%s' for writing!", path);
        return 1;
    }
    bool ok = std::fwrite(header, 1, std::strlen(header), f) == std::strlen(header);
    for (const auto& buf : buffers) {
        if (!buf.empty())
            ok = ok && std::fwrite(buf.data(), 1, buf.size(), f) == buf.size();
    }
    ok = (std::fclose(f) == 0) && ok;
    if (!ok) {
        std::snprintf(err, err_len, "Failed writing model file '%s'!", path);
        return 1;
    }
    return 0;
}

}  // extern "C"
