// dl4j_csv — native CSV -> float32 matrix parser (the PyTorch port's
// copy of `deeplearning4j_tpu/native/csv/`).
//
// DataVec's record-reading path (CSVRecordReader + the
// RecordReaderDataSetIterator pipeline) in one single-pass C++ parser:
// lines read through one growing buffer (getline), strtof-driven field
// scan, quote-aware, comment/blank-line skipping. Consumed through ctypes
// (deeplearning4j_tpu_torch/datasets/native_csv.py), which keeps a
// NumPy path with the same semantics for hosts without a toolchain.
//
// Build (deeplearning4j_tpu_torch/util/native_build.py does it at first
// use, into build/native/):
//   g++ -O2 -fPIC -shared -O3 dl4j_csv.cpp -o libdl4j_csv.so

#include <cstdio>
#include <cstdlib>
#include <sys/types.h>

namespace {

// '\n'-terminated lines through one growing buffer, the trailing '\r'
// of a CRLF file dropped; owns (and closes) the file.
struct Lines {
    FILE *f;
    char *buf = nullptr;
    size_t cap = 0;
    explicit Lines(FILE *file) : f(file) {}
    ~Lines() {
        free(buf);
        fclose(f);
    }
    // The next line, NUL-terminated and without its newline, or nullptr
    // at the end of the file.
    const char *next(size_t *len) {
        ssize_t n = getline(&buf, &cap, f);
        if (n < 0)
            return nullptr;
        if (n > 0 && buf[n - 1] == '\n')
            buf[--n] = '\0';
        if (n > 0 && buf[n - 1] == '\r')
            buf[--n] = '\0';
        *len = (size_t)n;
        return buf;
    }
};

inline bool pad(char ch) { return ch == ' ' || ch == '\t' || ch == '"'; }

}  // namespace

extern "C" {

// Scans the file once: number of data rows and the column count of the
// first data row. Returns 0 on success, negative on error.
//   skip_rows: header lines to skip (after comments and blank lines are
//   dropped); delim: field delimiter.
int dl4j_csv_shape(const char *path, char delim, long skip_rows,
                   long *rows_out, long *cols_out) {
    FILE *f = fopen(path, "rb");
    if (!f)
        return -1;
    Lines in(f);
    long rows = 0, cols = 0, lineno = 0;
    size_t len;
    while (const char *line = in.next(&len)) {
        if (len == 0 || line[0] == '#')
            continue;
        if (lineno >= skip_rows) {
            if (rows == 0) {
                long n = 1;
                bool quoted = false;
                for (size_t i = 0; i < len; i++) {
                    if (line[i] == '"')
                        quoted = !quoted;
                    else if (line[i] == delim && !quoted)
                        n++;
                }
                cols = n;
            }
            rows++;
        }
        lineno++;
    }
    *rows_out = rows;
    *cols_out = cols;
    return 0;
}

// Parses into the caller's [rows x cols] float32 buffer (row-major).
// Fields that are not one number (spaces and quotes aside) become NaN
// (the Python layer decides policy); a short row's missing fields too.
// Returns rows actually parsed, negative on error.
long dl4j_csv_parse(const char *path, char delim, long skip_rows,
                    float *out, long rows, long cols) {
    FILE *f = fopen(path, "rb");
    if (!f)
        return -1;
    Lines in(f);
    long r = 0, lineno = 0;
    size_t len;
    while (const char *line = in.next(&len)) {
        if (len == 0 || line[0] == '#')
            continue;
        if (lineno >= skip_rows && r < rows) {
            const char *p = line;
            for (long j = 0; j < cols; j++) {
                // the field's span first (quote-aware, from the field's
                // head so the quote state is always right), THEN the
                // value inside it
                const char *q = p;
                bool quoted = false;
                while (*q && (quoted || *q != delim)) {
                    if (*q == '"')
                        quoted = !quoted;
                    q++;
                }
                const char *fs = p;
                while (fs < q && pad(*fs))
                    fs++;
                char *endp = nullptr;
                float v = strtof(fs, &endp);
                // the number must fill the field (spaces and quotes
                // aside): "1,5" or "12abc" is not a number, as the NumPy
                // path's float() says
                const char *e = endp;
                while (e < q && pad(*e))
                    e++;
                out[r * cols + j] =
                    (endp == fs || e != q) ? __builtin_nanf("") : v;
                p = (*q == delim) ? q + 1 : q;
            }
            r++;
        }
        lineno++;
    }
    return r;
}

}  // extern "C"
