// Native ARFF parser: mmap ingest + multi-threaded row parsing.
//
// Counterpart of the reference's OpenMP-parallel parse_arff_file
// (src/plssvm/parameter.cpp:180-363), emitting CSR directly.  Exposed as a
// C API consumed through ctypes (plssvm_sparse_fp22/io/native.py); the
// pure-Python parser (io/arff.py) remains the fallback and the semantics
// oracle — error messages here must match it byte-for-byte.
//
// Semantics parity (parameter.cpp:195-330 / io/arff.py):
//   - comment char '%'; blank lines skipped; lines trimmed,
//   - header: @RELATION ignored; every @ATTRIBUTE must contain NUMERIC
//     (case-insensitive); a CLASS attribute marks the label column and must
//     be last; @DATA ends the header,
//   - sparse rows "{idx value, ...}": label at index num_attributes-1,
//     required when a CLASS attribute exists; out-of-range index rejected;
//     duplicate indices last-wins (the Python parser assigns into a dense
//     row),
//   - dense rows: comma-separated, exactly num_attributes fields,
//   - labels are sign-mapped during parsing (parameter.cpp:285,313).

#include <algorithm>
#include <charconv>
#include <cstdint>
#include <cstdio>
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

struct Line {
    const char* begin;
    const char* end;
};

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

inline const char* trim_back(const char* begin, const char* end) {
    while (end > begin &&
           (end[-1] == ' ' || end[-1] == '\t' || end[-1] == '\r')) --end;
    return end;
}

inline bool iequals_prefix(const char* p, const char* end, const char* upper) {
    for (; *upper; ++p, ++upper) {
        if (p >= end) return false;
        char c = *p;
        if (c >= 'a' && c <= 'z') c -= 32;
        if (c != *upper) return false;
    }
    return true;
}

inline bool icontains(const char* p, const char* end, const char* upper) {
    size_t m = std::strlen(upper);
    for (const char* q = p; q + m <= end; ++q) {
        size_t i = 0;
        for (; i < m; ++i) {
            char c = q[i];
            if (c >= 'a' && c <= 'z') c -= 32;
            if (c != upper[i]) break;
        }
        if (i == m) return true;
    }
    return false;
}

// Python-float-compatible conversion of a full token (leading '+' allowed).
inline bool parse_full_double(const char* p, const char* end, double* out) {
    if (p < end && *p == '+') ++p;
    auto [ptr, ec] = std::from_chars(p, end, *out);
    return ec == std::errc() && ptr == end;
}

inline bool parse_full_index(const char* p, const char* end, long long* out) {
    if (p < end && *p == '+') ++p;
    auto [ptr, ec] = std::from_chars(p, end, *out);
    return ec == std::errc() && ptr == end && *out >= 0;
}

struct Pair {
    int32_t idx;
    double val;
};

struct ThreadResult {
    std::vector<int64_t> row_nnz;
    std::vector<int32_t> indices;
    std::vector<double> values;
    std::vector<double> labels;  // sign-mapped
    std::string error;
};

void parse_rows(const std::vector<Line>& lines, size_t begin, size_t end,
                size_t data_start, int64_t num_attributes, bool has_label,
                ThreadResult* out) {
    int64_t num_features = has_label ? num_attributes - 1 : num_attributes;
    std::vector<Pair> row;
    auto fail = [&](std::string msg) { out->error = std::move(msg); };

    for (size_t li = begin; li < end; ++li) {
        size_t i = li - data_start;  // data-point number in messages
        const char* p = lines[li].begin;
        const char* lend = trim_back(p, lines[li].end);
        std::string istr = std::to_string(i);

        if (p < lend && *p == '@')
            return fail("Read @ inside data section!: '" + std::string(p, lend - p) + "'");

        row.clear();
        double label = 0.0;

        if (p < lend && *p == '{') {
            // sparse row (parameter.cpp:256-298)
            if (lend[-1] != '}')
                return fail("Missing closing '}' for sparse data point " + istr +
                            " description!");
            const char* body = p + 1;
            const char* body_end = lend - 1;
            bool is_class_set = false;
            while (body < body_end) {
                const char* comma = static_cast<const char*>(
                    ::memchr(body, ',', static_cast<size_t>(body_end - body)));
                const char* entry_end = comma ? comma : body_end;
                const char* e = skip_ws(body, entry_end);
                const char* ee = trim_back(e, entry_end);
                body = comma ? comma + 1 : body_end;
                if (e >= ee) continue;  // empty entry skipped
                // split on first whitespace run
                const char* sp = e;
                while (sp < ee && *sp != ' ' && *sp != '\t') ++sp;
                const char* v = skip_ws(sp, ee);
                if (sp == e || v >= ee || sp == ee)
                    return fail("Invalid sparse entry '" + std::string(e, ee - e) +
                                "' for data point " + istr + "!");
                long long index = 0;
                if (!parse_full_index(e, sp, &index))
                    return fail("Can't convert '" + std::string(e, sp - e) +
                                "' to a value of type unsigned long!");
                if (index >= num_attributes)
                    return fail("Too many features given! Trying to add feature at "
                                "position " + std::to_string(index) +
                                " but max position is " +
                                std::to_string(num_features - 1) + "!");
                double value = 0.0;
                if (!parse_full_double(v, ee, &value))
                    return fail("Can't convert '" + std::string(v, ee - v) +
                                "' to a value of type real_type!");
                if (has_label && index == num_attributes - 1) {
                    is_class_set = true;
                    label = value > 0 ? 1.0 : -1.0;
                } else {
                    row.push_back({static_cast<int32_t>(index), value});
                }
            }
            if (has_label && !is_class_set)
                return fail("Missing label for data point " + istr + "!");
        } else {
            // dense row (parameter.cpp:299-322): the field *count* is
            // validated before any value conversion, like the oracle
            std::vector<std::pair<const char*, const char*>> fields;
            const char* q = p;
            while (true) {
                const char* comma = static_cast<const char*>(
                    ::memchr(q, ',', static_cast<size_t>(lend - q)));
                const char* fend = comma ? comma : lend;
                fields.emplace_back(q, fend);
                if (!comma) break;
                q = comma + 1;
            }
            if (static_cast<int64_t>(fields.size()) < num_attributes)
                return fail("Invalid number of features/labels! Found " +
                            std::to_string(fields.size() - 1) + " but should be " +
                            std::to_string(num_attributes - 1) + "!");
            if (static_cast<int64_t>(fields.size()) > num_attributes)
                return fail("Too many features! Superfluous '" +
                            std::string(fields[num_attributes].first, lend -
                                        fields[num_attributes].first) +
                            "' for data point " + istr + "!");
            for (int64_t field = 0; field < num_attributes; ++field) {
                const char* fs = skip_ws(fields[field].first, fields[field].second);
                const char* fe = trim_back(fs, fields[field].second);
                double value = 0.0;
                if (!parse_full_double(fs, fe, &value))
                    return fail("Can't convert '" + std::string(fs, fe - fs) +
                                "' to a value of type real_type!");
                if (has_label && field == num_attributes - 1)
                    label = value > 0 ? 1.0 : -1.0;
                else if (value != 0.0)
                    row.push_back({static_cast<int32_t>(field), value});
            }
        }

        // CSR row: sorted by index, duplicates last-wins, zeros dropped
        std::stable_sort(row.begin(), row.end(),
                         [](const Pair& a, const Pair& b) { return a.idx < b.idx; });
        int64_t nnz = 0;
        for (size_t k = 0; k < row.size(); ++k) {
            if (k + 1 < row.size() && row[k + 1].idx == row[k].idx) continue;
            if (row[k].val == 0.0) continue;
            out->indices.push_back(row[k].idx);
            out->values.push_back(row[k].val);
            ++nnz;
        }
        out->row_nnz.push_back(nnz);
        out->labels.push_back(label);
    }
}

}  // namespace

extern "C" {

// Parse an ARFF file into CSR arrays.  Returns 0 on success, nonzero on
// error with a message in err.  Out arrays are malloc'd; release with
// plssvm_native_free (libsvm_parser.cpp).
int plssvm_native_parse_arff(
    const char* path,
    int64_t** out_indptr,   // (n_rows + 1)
    int32_t** out_indices,  // (nnz)
    double** out_values,    // (nnz)
    double** out_labels,    // (n_rows); sign-mapped, valid iff has_labels
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
    auto cleanup = [&]() { if (mapped) ::munmap(mapped, size); };

    // non-blank, non-comment ('%') lines (file_reader.cpp:129-152)
    std::vector<Line> lines;
    {
        const char* p = content;
        const char* end = content + size;
        while (p < end) {
            const char* nl = static_cast<const char*>(
                ::memchr(p, '\n', static_cast<size_t>(end - p)));
            const char* lend = nl ? nl : end;
            const char* ls = skip_ws(p, lend);
            if (ls < trim_back(ls, lend) && *ls != '%') lines.push_back({ls, lend});
            p = nl ? nl + 1 : end;
        }
    }

    // header (parameter.cpp:195-228)
    int64_t num_attributes = 0;
    bool has_label = false;
    size_t header_end = lines.size();
    for (size_t li = 0; li < lines.size(); ++li) {
        const char* p = lines[li].begin;
        const char* lend = trim_back(p, lines[li].end);
        if (iequals_prefix(p, lend, "@RELATION")) {
            continue;
        } else if (iequals_prefix(p, lend, "@ATTRIBUTE")) {
            if (!icontains(p, lend, "NUMERIC")) {
                // materialize the message BEFORE munmap: it reads mapped bytes
                std::string msg = "Can only use NUMERIC features, but '" +
                                  std::string(p, lend - p) + "' was given!";
                cleanup();
                return fail(msg);
            }
            if (has_label) {
                cleanup();
                return fail("Only the last ATTRIBUTE may be CLASS!");
            }
            if (icontains(p, lend, "CLASS")) has_label = true;
            ++num_attributes;
        } else if (iequals_prefix(p, lend, "@DATA")) {
            header_end = li;
            break;
        }
    }

    if (num_attributes == 0) {
        cleanup();
        return fail("Can't parse file: no ATTRIBUTES are defined!");
    }
    if (header_end == lines.size() || header_end + 1 >= lines.size()) {
        cleanup();
        return fail("Can't parse file: no data points are given or @DATA is missing!");
    }

    size_t data_start = header_end + 1;
    size_t n_rows = lines.size() - data_start;
    unsigned hw = std::thread::hardware_concurrency();
    size_t n_threads = std::max<size_t>(1, std::min<size_t>(hw ? hw : 1, n_rows));
    std::vector<ThreadResult> results(n_threads);
    {
        std::vector<std::thread> threads;
        size_t chunk = (n_rows + n_threads - 1) / n_threads;
        for (size_t t = 0; t < n_threads; ++t) {
            size_t b = data_start + t * chunk;
            size_t e = std::min(lines.size(), b + chunk);
            if (b >= e) break;
            threads.emplace_back(parse_rows, std::cref(lines), b, e, data_start,
                                 num_attributes, has_label, &results[t]);
        }
        for (auto& th : threads) th.join();
    }

    int64_t total_nnz = 0;
    for (const auto& r : results) {
        if (!r.error.empty()) {  // lowest chunk's error = first bad row
            cleanup();
            return fail(r.error);
        }
        total_nnz += static_cast<int64_t>(r.values.size());
    }

    auto* indptr = static_cast<int64_t*>(std::malloc((n_rows + 1) * sizeof(int64_t)));
    auto* indices = static_cast<int32_t*>(std::malloc(std::max<int64_t>(total_nnz, 1) * sizeof(int32_t)));
    auto* values = static_cast<double*>(std::malloc(std::max<int64_t>(total_nnz, 1) * sizeof(double)));
    auto* labels = static_cast<double*>(std::malloc(std::max<size_t>(n_rows, 1) * sizeof(double)));
    if (!indptr || !indices || !values || !labels) {
        std::free(indptr); std::free(indices); std::free(values); std::free(labels);
        cleanup();
        return fail("out of memory");
    }

    int64_t row = 0, pos = 0;
    indptr[0] = 0;
    for (const auto& r : results) {
        std::memcpy(indices + pos, r.indices.data(), r.indices.size() * sizeof(int32_t));
        std::memcpy(values + pos, r.values.data(), r.values.size() * sizeof(double));
        for (size_t k = 0; k < r.row_nnz.size(); ++k) {
            labels[row] = r.labels[k];
            indptr[row + 1] = indptr[row] + r.row_nnz[k];
            ++row;
        }
        pos += static_cast<int64_t>(r.values.size());
    }
    cleanup();

    *out_indptr = indptr;
    *out_indices = indices;
    *out_values = values;
    *out_labels = labels;
    *out_n_rows = static_cast<int64_t>(n_rows);
    *out_nnz = total_nnz;
    *out_n_features = has_label ? num_attributes - 1 : num_attributes;
    *out_has_labels = has_label ? 1 : 0;
    return 0;
}

}  // extern "C"
