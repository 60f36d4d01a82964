// Minimal {fmt}-compatible shim for building the reference PLSSVM without
// network access (FetchContent cannot run in this environment).  ORIGINAL
// CODE: implements, from scratch on top of <charconv>/<cstdio>/<sstream>,
// exactly the API surface the reference uses — sequential "{}" replacement
// (plus the "{:e}" and "{:02x}" specs it contains), fmt::print (stdout /
// FILE* / styled), fmt::join, fmt::format_to, fmt::output_file, chrono
// durations, and ostream-insertable types.  Not a general fmt replacement.
#ifndef PLSSVM_INTEROP_FMT_CORE_H_
#define PLSSVM_INTEROP_FMT_CORE_H_

#include <charconv>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ratio>
#include <sstream>
#include <stdexcept>
#include <string>
#include <string_view>
#include <type_traits>
#include <utility>
#include <vector>

namespace fmt {

namespace shim_detail {

// -- trait: does T support `ostream << T`?
template <typename T, typename = void>
struct is_streamable : std::false_type {};
template <typename T>
struct is_streamable<T, std::void_t<decltype(std::declval<std::ostream &>()
                                             << std::declval<const T &>())>>
    : std::true_type {};

template <typename T>
struct is_duration : std::false_type {};
template <typename R, typename P>
struct is_duration<std::chrono::duration<R, P>> : std::true_type {};

template <typename P>
inline const char *duration_suffix() {
    if (std::ratio_equal<P, std::milli>::value) return "ms";
    if (std::ratio_equal<P, std::micro>::value) return "us";
    if (std::ratio_equal<P, std::nano>::value) return "ns";
    if (std::ratio_equal<P, std::ratio<1>>::value) return "s";
    if (std::ratio_equal<P, std::ratio<60>>::value) return "min";
    if (std::ratio_equal<P, std::ratio<3600>>::value) return "h";
    return "";
}

// Unrecognized specs throw instead of silently falling back to the default
// formatting: if a reference upstream ever grows a new spec (say "{:.10e}"),
// a shim-built reference must fail LOUDLY rather than produce text that
// differs from a genuine-fmt build.
[[noreturn]] inline void unsupported_spec(std::string_view spec) {
    throw std::runtime_error("fmt shim: unsupported format spec '" +
                             std::string(spec) + "'");
}

// format one value under a (possibly empty) spec such as "", "e", "02x"
template <typename T>
std::string format_value(const T &value, std::string_view spec) {
    using D = std::decay_t<T>;
    if constexpr (std::is_same_v<D, bool>) {
        if (!spec.empty()) unsupported_spec(spec);
        return value ? "true" : "false";
    } else if constexpr (std::is_floating_point_v<D>) {
        char buf[64];
        if (spec == "e") {
            std::snprintf(buf, sizeof(buf), "%e", static_cast<double>(value));
            return buf;
        }
        if (!spec.empty()) unsupported_spec(spec);
        auto res = std::to_chars(buf, buf + sizeof(buf),
                                 static_cast<double>(value));
        return std::string(buf, res.ptr);
    } else if constexpr (std::is_integral_v<D>) {
        char buf[32];
        if (spec == "02x") {
            std::snprintf(buf, sizeof(buf), "%02x",
                          static_cast<unsigned>(value));
            return buf;
        }
        if (!spec.empty()) unsupported_spec(spec);
        auto res = std::to_chars(buf, buf + sizeof(buf), value);
        return std::string(buf, res.ptr);
    } else if constexpr (std::is_convertible_v<D, std::string_view>) {
        if (!spec.empty()) unsupported_spec(spec);
        return std::string(std::string_view(value));
    } else if constexpr (is_duration<D>::value) {
        if (!spec.empty()) unsupported_spec(spec);
        return format_value(value.count(), "") +
               duration_suffix<typename D::period>();
    } else if constexpr (is_streamable<D>::value) {
        if (!spec.empty()) unsupported_spec(spec);
        std::ostringstream os;
        os << value;
        return os.str();
    } else {
        static_assert(is_streamable<D>::value,
                      "fmt shim: unsupported argument type");
        return {};
    }
}

// erase heterogeneous args into spec -> string closures
using formatter_fn = std::string (*)(const void *, std::string_view);
struct arg_ref {
    const void *ptr;
    formatter_fn fn;
};

template <typename T>
std::string call_formatter(const void *p, std::string_view spec) {
    return format_value(*static_cast<const T *>(p), spec);
}

inline std::string vformat(std::string_view f, const std::vector<arg_ref> &args) {
    std::string out;
    out.reserve(f.size() + 16 * args.size());
    std::size_t next = 0;
    for (std::size_t i = 0; i < f.size(); ++i) {
        char c = f[i];
        if (c == '{') {
            if (i + 1 < f.size() && f[i + 1] == '{') {  // escaped brace
                out.push_back('{');
                ++i;
                continue;
            }
            std::size_t close = f.find('}', i);
            if (close == std::string_view::npos)
                throw std::runtime_error("fmt shim: unmatched '{'");
            std::string_view inner = f.substr(i + 1, close - i - 1);
            std::string_view spec;
            if (auto colon = inner.find(':'); colon != std::string_view::npos)
                spec = inner.substr(colon + 1);
            if (next >= args.size())
                throw std::runtime_error("fmt shim: not enough arguments");
            const arg_ref &a = args[next++];
            out += a.fn(a.ptr, spec);
            i = close;
        } else if (c == '}') {
            if (i + 1 < f.size() && f[i + 1] == '}') ++i;  // escaped brace
            out.push_back('}');
        } else {
            out.push_back(c);
        }
    }
    return out;
}

}  // namespace shim_detail

template <typename... Args>
std::string format(std::string_view f, const Args &...args) {
    std::vector<shim_detail::arg_ref> refs = {
        shim_detail::arg_ref{static_cast<const void *>(&args),
                             &shim_detail::call_formatter<Args>}...};
    return shim_detail::vformat(f, refs);
}

template <typename OutIt, typename... Args>
OutIt format_to(OutIt out, std::string_view f, const Args &...args) {
    std::string s = format(f, args...);
    if constexpr (std::is_pointer_v<OutIt>) {
        std::memcpy(out, s.data(), s.size());
        return out + s.size();
    } else {
        for (char c : s) *out++ = c;
        return out;
    }
}

template <typename... Args>
void print(std::string_view f, const Args &...args) {
    std::string s = format(f, args...);
    std::fwrite(s.data(), 1, s.size(), stdout);
}

template <typename... Args>
void print(std::FILE *stream, std::string_view f, const Args &...args) {
    std::string s = format(f, args...);
    std::fwrite(s.data(), 1, s.size(), stream);
}

// fmt::join — materialized immediately (the result is only ever consumed by
// a "{}" placeholder in the reference)
template <typename Range>
std::string join(const Range &range, std::string_view sep) {
    std::string out;
    bool first = true;
    for (const auto &item : range) {
        if (!first) out += std::string(sep);
        first = false;
        out += shim_detail::format_value(item, "");
    }
    return out;
}

}  // namespace fmt

#endif  // PLSSVM_INTEROP_FMT_CORE_H_
