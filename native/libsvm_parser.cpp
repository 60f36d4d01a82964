// Native LIBSVM parser: mmap ingest + multi-threaded sparse-line parsing.
//
// The JAX framework's counterpart of the reference's native data-loading
// path: mmap-based file_reader (src/plssvm/detail/file_reader.cpp:72-100)
// plus the OpenMP-parallel parse_libsvm_content
// (src/plssvm/parameter.cpp:41-116), re-designed to emit CSR directly
// (indptr/indices/data) instead of densified rows, with std::thread
// parallelism.  Exposed as a C API consumed through ctypes
// (plssvm_sparse_fp22/io/native.py); the pure-Python parser remains the
// fallback and the semantics oracle.
//
// Semantics parity with the reference parser:
//   - lines: leading whitespace trimmed; blank lines and lines whose first
//     non-blank char is '#' are skipped (file_reader.cpp:129-152),
//   - a line whose first token contains ':' has no label; any unlabeled
//     line marks the whole file unlabeled (parameter.cpp:55-63),
//   - parsing of a line stops at the first token without ':' (tolerates
//     trailing inline comments, parameter.cpp:67-70),
//   - feature count = max index + 1; no pairs at all -> error.

#include <algorithm>
#include <charconv>
#include <atomic>
#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct LineRange {
    const char* begin;
    const char* end;
};

struct ThreadResult {
    std::vector<int64_t> row_nnz;
    std::vector<int32_t> indices;
    std::vector<double> values;
    std::vector<double> labels;
    bool any_unlabeled = false;
    int64_t max_index = -1;
    std::string error;
};

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

void parse_lines(const std::vector<LineRange>& lines, size_t begin, size_t end,
                 ThreadResult* out) {
    out->row_nnz.reserve(end - begin);
    out->labels.reserve(end - begin);
    for (size_t li = begin; li < end; ++li) {
        const char* p = lines[li].begin;
        const char* lend = lines[li].end;
        int64_t nnz = 0;
        double label = 0.0;
        bool labeled = false;

        // first token: label unless it contains ':'
        p = skip_ws(p, lend);
        const char* tok_end = p;
        bool has_colon = false;
        while (tok_end < lend && *tok_end != ' ' && *tok_end != '\t') {
            if (*tok_end == ':') has_colon = true;
            ++tok_end;
        }
        if (!has_colon && tok_end > p) {
            auto [ptr, ec] = std::from_chars(p, tok_end, label);
            if (ec != std::errc()) {
                out->error = "Can't convert '" + std::string(p, tok_end - p) +
                             "' to a value of type real_type!";
                return;
            }
            labeled = true;
            p = tok_end;
        } else {
            out->any_unlabeled = true;
        }

        // index:value pairs; stop at first token without ':'
        while (true) {
            p = skip_ws(p, lend);
            if (p >= lend) break;
            const char* colon = p;
            while (colon < lend && *colon != ':' && *colon != ' ' && *colon != '\t')
                ++colon;
            if (colon >= lend || *colon != ':') break;  // inline comment etc.

            long long idx = 0;
            auto [iptr, iec] = std::from_chars(p, colon, idx);
            if (iec != std::errc() || iptr != colon || idx < 0) {
                out->error = "Can't convert '" + std::string(p, colon - p) +
                             "' to a value of type unsigned long!";
                return;
            }
            const char* vstart = colon + 1;
            double value = 0.0;
            auto [vptr, vec] = std::from_chars(vstart, lend, value);
            if (vec != std::errc()) {
                out->error = "Can't convert '" +
                             std::string(vstart, std::min<std::ptrdiff_t>(lend - vstart, 32)) +
                             "' to a value of type real_type!";
                return;
            }
            out->indices.push_back(static_cast<int32_t>(idx));
            out->values.push_back(value);
            if (idx > out->max_index) out->max_index = idx;
            ++nnz;
            p = vptr;
        }

        out->row_nnz.push_back(nnz);
        out->labels.push_back(labeled ? label : 0.0);
    }
}

}  // namespace

extern "C" {

// Parse a LIBSVM file into CSR arrays.  Returns 0 on success, nonzero on
// error with a message in err (truncated to err_len).  All out arrays are
// malloc'd; release with plssvm_native_free.
int plssvm_native_parse_libsvm(
    const char* path,
    int64_t** out_indptr,   // (n_rows + 1)
    int32_t** out_indices,  // (nnz)
    double** out_values,    // (nnz)
    double** out_labels,    // (n_rows); raw values, sign-mapping is caller's
    int64_t* out_n_rows,
    int64_t* out_nnz,
    int64_t* out_n_features,
    int* out_has_labels,
    char* err, size_t err_len) {
    auto fail = [&](const std::string& msg) {
        std::snprintf(err, err_len, "%s", msg.c_str());
        return 1;
    };

    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return fail("Couldn't find file: '" + std::string(path) + "'!");
    struct stat st{};
    if (::fstat(fd, &st) != 0) {
        ::close(fd);
        return fail("stat failed for '" + std::string(path) + "'");
    }
    size_t size = static_cast<size_t>(st.st_size);
    const char* content = nullptr;
    void* mapped = nullptr;
    if (size > 0) {
        mapped = ::mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (mapped == MAP_FAILED) {
            ::close(fd);
            return fail("mmap failed for '" + std::string(path) + "'");
        }
        content = static_cast<const char*>(mapped);
    }
    ::close(fd);

    // line scan: collect non-blank, non-comment lines (file_reader.cpp:129-152)
    std::vector<LineRange> lines;
    {
        const char* p = content;
        const char* end = content + size;
        while (p < end) {
            const char* nl = static_cast<const char*>(
                ::memchr(p, '\n', static_cast<size_t>(end - p)));
            const char* lend = nl ? nl : end;
            const char* ls = skip_ws(p, lend);
            if (ls < lend && *ls != '#') lines.push_back({ls, lend});
            p = nl ? nl + 1 : end;
        }
    }

    size_t n_rows = lines.size();
    unsigned hw = std::thread::hardware_concurrency();
    size_t n_threads = std::max<size_t>(1, std::min<size_t>(hw ? hw : 1, n_rows ? n_rows : 1));
    std::vector<ThreadResult> results(n_threads);
    {
        std::vector<std::thread> threads;
        size_t chunk = (n_rows + n_threads - 1) / n_threads;
        for (size_t t = 0; t < n_threads; ++t) {
            size_t b = t * chunk;
            size_t e = std::min(n_rows, b + chunk);
            if (b >= e) break;
            threads.emplace_back(parse_lines, std::cref(lines), b, e, &results[t]);
        }
        for (auto& th : threads) th.join();
    }

    int64_t max_index = -1;
    bool any_unlabeled = false;
    int64_t total_nnz = 0;
    for (const auto& r : results) {
        if (!r.error.empty()) {
            if (mapped) ::munmap(mapped, size);
            return fail(r.error);
        }
        max_index = std::max(max_index, r.max_index);
        any_unlabeled |= r.any_unlabeled;
        total_nnz += static_cast<int64_t>(r.values.size());
    }
    if (max_index < 0) {
        if (mapped) ::munmap(mapped, size);
        return fail("Can't parse file: no data points are given!");
    }

    auto* indptr = static_cast<int64_t*>(std::malloc((n_rows + 1) * sizeof(int64_t)));
    auto* indices = static_cast<int32_t*>(std::malloc(std::max<int64_t>(total_nnz, 1) * sizeof(int32_t)));
    auto* values = static_cast<double*>(std::malloc(std::max<int64_t>(total_nnz, 1) * sizeof(double)));
    auto* labels = static_cast<double*>(std::malloc(std::max<size_t>(n_rows, 1) * sizeof(double)));
    if (!indptr || !indices || !values || !labels) {
        std::free(indptr); std::free(indices); std::free(values); std::free(labels);
        if (mapped) ::munmap(mapped, size);
        return fail("out of memory");
    }

    int64_t row = 0, pos = 0;
    indptr[0] = 0;
    for (const auto& r : results) {
        std::memcpy(indices + pos, r.indices.data(), r.indices.size() * sizeof(int32_t));
        std::memcpy(values + pos, r.values.data(), r.values.size() * sizeof(double));
        for (size_t i = 0; i < r.row_nnz.size(); ++i) {
            labels[row] = r.labels[i];
            indptr[row + 1] = indptr[row] + r.row_nnz[i];
            ++row;
        }
        pos += static_cast<int64_t>(r.values.size());
    }

    if (mapped) ::munmap(mapped, size);

    *out_indptr = indptr;
    *out_indices = indices;
    *out_values = values;
    *out_labels = labels;
    *out_n_rows = static_cast<int64_t>(n_rows);
    *out_nnz = total_nnz;
    *out_n_features = max_index + 1;
    *out_has_labels = any_unlabeled ? 0 : 1;
    return 0;
}

void plssvm_native_free(void* p) { std::free(p); }

}  // extern "C"
