// Fast MatrixMarket coordinate-body parser.
//
// np.loadtxt tokenizes ~1M lines/s; SuiteSparse matrices reach 10^8 entries,
// so the hot loop is a strtoll/strtod sweep instead (~30-60M entries/s).
// Exposed as a plain C ABI consumed via ctypes (sparse_tpu/io/fastmm.py);
// the Python layer owns all validation and format dispatch.
//
// Build: g++ -O3 -shared -fPIC -o _fastmm.so _fastmm.cpp  (done lazily and
// cached by fastmm.py; absence of a toolchain degrades to np.loadtxt).

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parse `nnz` coordinate lines from buf[0:len): "row col [value]".
// rows/cols are written 0-based.  pattern != 0 means no value column
// (values filled with 1.0).  Returns the number of entries parsed
// (== nnz on success; short count signals malformed input).
int64_t parse_mm_coordinate(const char* buf, int64_t len, int64_t nnz,
                            int64_t* rows, int64_t* cols, double* vals,
                            int pattern) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t k = 0;
  while (k < nnz && p < end) {
    // skip whitespace / blank lines / comments
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
    if (p >= end) break;
    if (*p == '%') {  // comment line
      while (p < end && *p != '\n') ++p;
      continue;
    }
    char* q;
    long long r = strtoll(p, &q, 10);
    if (q == p) break;
    p = q;
    long long c = strtoll(p, &q, 10);
    if (q == p) break;
    p = q;
    double v = 1.0;
    if (!pattern) {
      v = strtod(p, &q);
      if (q == p) break;
      p = q;
    }
    rows[k] = r - 1;
    cols[k] = c - 1;
    vals[k] = v;
    ++k;
  }
  return k;
}

// Parse `count` whitespace-separated real numbers (array format body).
int64_t parse_mm_array(const char* buf, int64_t len, int64_t count,
                       double* vals) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t k = 0;
  while (k < count && p < end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
    if (p >= end) break;
    if (*p == '%') {
      while (p < end && *p != '\n') ++p;
      continue;
    }
    char* q;
    double v = strtod(p, &q);
    if (q == p) break;
    p = q;
    vals[k++] = v;
  }
  return k;
}

}  // extern "C"
