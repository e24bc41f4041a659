// Native OpenFOAM ASCII list tokenizers.
//
// The Python reader (foam/tokenizer.py) handles the FoamFile header and list
// framing; these functions do the raw numeric scanning at C speed.  They are
// the host-side "runtime" component of the framework: for multi-million-cell
// meshes the faces file (mixed-size faceList) is the parse bottleneck — the
// pure-numpy fast path only covers uniform face sizes, and the Python cursor
// walk over a mixed faceList is ~100x slower than this.
//
// Build: g++ -O3 -shared -fPIC -o libfoamparse.so foam_parse.cpp, done at
// first use by gnn_bfs_rans_tpu_torch/native/__init__.py into the
// package's build/ directory and loaded there via ctypes; without a
// compiler the tokenizer keeps its numpy walk (and logs a warning).

#include <cstdint>
#include <cstdlib>
#include <cctype>

extern "C" {

// Parse up to max_out whitespace/punctuation-separated doubles from text.
// Returns the number parsed.  Parentheses are treated as separators.
int64_t foam_parse_doubles(const char* text, int64_t len, double* out,
                           int64_t max_out) {
    const char* p = text;
    const char* end = text + len;
    int64_t n = 0;
    while (p < end && n < max_out) {
        // skip separators
        while (p < end && !(*p == '-' || *p == '+' || *p == '.' ||
                            (*p >= '0' && *p <= '9'))) {
            ++p;
        }
        if (p >= end) break;
        char* next = nullptr;
        double v = strtod(p, &next);
        if (next == p) { ++p; continue; }
        out[n++] = v;
        p = next;
    }
    return n;
}

// Parse int32 labels; same contract as foam_parse_doubles.
int64_t foam_parse_labels(const char* text, int64_t len, int32_t* out,
                          int64_t max_out) {
    const char* p = text;
    const char* end = text + len;
    int64_t n = 0;
    while (p < end && n < max_out) {
        while (p < end && !(*p == '-' || (*p >= '0' && *p <= '9'))) ++p;
        if (p >= end) break;
        char* next = nullptr;
        long v = strtol(p, &next, 10);
        if (next == p) { ++p; continue; }
        out[n++] = (int32_t)v;
        p = next;
    }
    return n;
}

// Parse a faceList body "k(p0 ... pk-1) ..." into CSR offsets/points.
// offsets must hold n_faces+1 entries; points must hold max_points.
// Returns the number of faces parsed, or -1 if points overflowed.
int64_t foam_parse_faces(const char* text, int64_t len, int64_t n_faces,
                         int32_t* offsets, int32_t* points,
                         int64_t max_points) {
    const char* p = text;
    const char* end = text + len;
    int64_t face = 0;
    int64_t np_total = 0;
    offsets[0] = 0;
    while (p < end && face < n_faces) {
        while (p < end && !(*p >= '0' && *p <= '9')) ++p;
        if (p >= end) break;
        char* next = nullptr;
        long k = strtol(p, &next, 10);
        p = next;
        // expect '(' then k point indices then ')'
        while (p < end && *p != '(') ++p;
        if (p < end) ++p;
        for (long i = 0; i < k; ++i) {
            while (p < end && !(*p >= '0' && *p <= '9')) ++p;
            if (p >= end) return face;
            long v = strtol(p, &next, 10);
            p = next;
            if (np_total >= max_points) return -1;
            points[np_total++] = (int32_t)v;
        }
        while (p < end && *p != ')') ++p;
        if (p < end) ++p;
        ++face;
        offsets[face] = (int32_t)np_total;
    }
    return face;
}

}  // extern "C"
