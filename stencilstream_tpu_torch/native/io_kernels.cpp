// Native host I/O of stencilstream_tpu_torch: grid file-format parsing and
// formatting, the host-side data path around the card's kernels (an 8192^2
// HotSpot text file is ~700 MB of ASCII). A copy of the JAX package's
// stencilstream_tpu/native/io_kernels.cpp, so that both packages write the
// same bytes. Formats match the reference apps exactly:
//   * Conway 'X'/'.' char grids        (examples/conway/conway.cpp:58-88)
//   * HotSpot whitespace float text    (examples/hotspot/hotspot.cpp:141-202)
//   * HotSpot "<index>\t<value>" dumps (examples/hotspot/hotspot.cpp:156-163)
//   * FDTD/Convection CSV frames       (examples/fdtd/src/fdtd.cpp:114-166)
//
// Exposed with a plain-C ABI and driven from Python via ctypes
// (stencilstream_tpu_torch/native/__init__.py; no CPython API). All
// functions are single-pass, allocation-free, and return negative error
// codes documented per function.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>

extern "C" {

// Parse an 'X'/'.' grid, skipping whitespace. Returns 0 on success,
// -(1+cell_index) if the input is truncated at cell_index, or
// -(1+n_cells+cell_index) on an unexpected character at cell_index.
int64_t ss_parse_char_grid(const char* text, int64_t text_len,
                           int64_t height, int64_t width, uint8_t* out) {
    const char* p = text;
    const char* end = text + text_len;
    int64_t cells = height * width;
    for (int64_t i = 0; i < cells; ++i) {
        char ch;
        for (;;) {
            if (p == end) return -(1 + i);
            ch = *p++;
            if (ch != ' ' && ch != '\n' && ch != '\r' && ch != '\t' &&
                ch != '\v' && ch != '\f')
                break;
        }
        if (ch == 'X') out[i] = 1;
        else if (ch == '.') out[i] = 0;
        else return -(1 + cells + i);
    }
    return 0;
}

// Format a grid as 'X'/'.' rows with trailing newlines.
// out must hold height * (width + 1) bytes. Returns bytes written.
int64_t ss_format_char_grid(const uint8_t* grid, int64_t height,
                            int64_t width, char* out) {
    char* q = out;
    for (int64_t r = 0; r < height; ++r) {
        const uint8_t* row = grid + r * width;
        for (int64_t c = 0; c < width; ++c) *q++ = row[c] ? 'X' : '.';
        *q++ = '\n';
    }
    return q - out;
}

// Parse `count` whitespace-separated floats. Returns number parsed
// (== count on success; fewer on truncation/garbage).
int64_t ss_parse_floats(const char* text, int64_t text_len, int64_t count,
                        float* out) {
    const char* p = text;
    const char* end = text + text_len;
    int64_t n = 0;
    while (n < count) {
        while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' ||
                           *p == '\t' || *p == '\v' || *p == '\f'))
            ++p;
        if (p >= end) break;
        char* after = nullptr;
        // strtof needs NUL-terminated input in the worst case; the Python
        // wrapper guarantees a trailing NUL byte past text_len.
        float v = strtof(p, &after);
        if (after == p) break;
        out[n++] = v;
        p = after;
    }
    return n;
}

// Format "<flat index>\t<%g value>\n" lines (HotSpot text output).
// out must hold >= n * 32 bytes. Returns bytes written.
int64_t ss_format_indexed_text(const float* vals, int64_t n, char* out) {
    char* q = out;
    for (int64_t i = 0; i < n; ++i)
        q += snprintf(q, 32, "%lld\t%g\n", (long long)i, (double)vals[i]);
    return q - out;
}

// Format a float matrix as comma-separated "%g" rows (CSV frames).
// out must hold >= height * width * 16 bytes. Returns bytes written.
int64_t ss_format_csv(const float* vals, int64_t height, int64_t width,
                      char* out) {
    char* q = out;
    for (int64_t r = 0; r < height; ++r) {
        const float* row = vals + r * width;
        for (int64_t c = 0; c < width; ++c) {
            q += snprintf(q, 16, "%g", (double)row[c]);
            *q++ = (c + 1 == width) ? '\n' : ',';
        }
    }
    return q - out;
}

// Same for double input (convection frames are written from f64 hosts).
int64_t ss_format_csv_f64(const double* vals, int64_t height, int64_t width,
                          char* out) {
    char* q = out;
    for (int64_t r = 0; r < height; ++r) {
        const double* row = vals + r * width;
        for (int64_t c = 0; c < width; ++c) {
            q += snprintf(q, 24, "%g", row[c]);
            *q++ = (c + 1 == width) ? '\n' : ',';
        }
    }
    return q - out;
}

}  // extern "C"
