// fastparse: the native text-format data loader (libsvm + CSV) of
// xgboost_tpu_torch, the counterpart of the reference's dmlc-core text
// parsers (dmlc/data.h ParseLibSVM/CSV used via DMatrix::Load,
// src/data/data.cc). mmap + a single pass with hand-rolled number scanning.
//
// Plain C ABI for ctypes, built with g++ at first use
// (xgboost_tpu_torch/native/__init__.py). An empty file maps to zero bytes
// and parses to zero rows; a file that cannot be opened returns -1.

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = ::open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0) {
    ::close(m.fd);
    m.fd = -1;
    return m;
  }
  if (st.st_size == 0) {  // nothing to map: an empty, valid view
    m.data = "";
    return m;
  }
  void* p = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    ::close(m.fd);
    m.fd = -1;
    return m;
  }
  ::madvise(p, st.st_size, MADV_SEQUENTIAL);
  m.data = static_cast<const char*>(p);
  m.size = static_cast<size_t>(st.st_size);
  return m;
}

void unmap(Mapped& m) {
  if (m.data && m.size) ::munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) ::close(m.fd);
  m.data = nullptr;
  m.fd = -1;
}

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

// fast float scan: sign, digits, '.', digits, optional exponent.
// Falls back to strtof for unusual forms (inf/nan/hex).
inline const char* scan_float(const char* p, const char* end, float* out) {
  const char* start = p;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
  double mant = 0.0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    mant = mant * 10.0 + (*p - '0');
    ++p;
    any = true;
  }
  if (p < end && *p == '.') {
    ++p;
    double scale = 0.1;
    while (p < end && *p >= '0' && *p <= '9') {
      mant += (*p - '0') * scale;
      scale *= 0.1;
      ++p;
      any = true;
    }
  }
  if (!any) {  // nan / inf / weird: defer to libc via a bounded NUL'd copy
    // (the mmap is not NUL-terminated; strtof on the raw pointer could read
    // past the mapping on a page-aligned file)
    char buf[64];
    size_t len = static_cast<size_t>(end - start);
    if (len > sizeof(buf) - 1) len = sizeof(buf) - 1;
    memcpy(buf, start, len);
    buf[len] = '\0';
    char* e = nullptr;
    float v = strtof(buf, &e);
    if (e == buf) {
      *out = NAN;
      return start;  // no progress: caller must skip the token
    }
    *out = v;
    return start + (e - buf);
  }
  if (p < end && (*p == 'e' || *p == 'E')) {
    ++p;
    bool eneg = false;
    if (p < end && (*p == '-' || *p == '+')) {
      eneg = (*p == '-');
      ++p;
    }
    int ex = 0;
    while (p < end && *p >= '0' && *p <= '9') {
      ex = ex * 10 + (*p - '0');
      ++p;
    }
    mant *= pow(10.0, eneg ? -ex : ex);
  }
  *out = static_cast<float>(neg ? -mant : mant);
  return p;
}

inline const char* scan_int(const char* p, const char* end, long* out) {
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
  long v = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
  }
  *out = neg ? -v : v;
  return p;
}

// skip a malformed token so the scan loops always make progress
inline const char* skip_token(const char* p, const char* end) {
  while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
  return p;
}

// A CSV "data line" starts with something number-like; headers and comments
// don't (np.loadtxt likewise skips '#' and chokes on text headers — we skip
// both kinds of non-data line). 'nan'/'inf' tokens count as numeric.
inline bool csv_data_line(const char* p, const char* end) {
  p = skip_ws(p, end);
  if (p >= end) return false;
  char c = *p;
  if ((c >= '0' && c <= '9') || c == '-' || c == '+' || c == '.' || c == ',')
    return true;
  auto tok3 = [&](const char* w) {
    if (end - p < 3) return false;
    for (int i = 0; i < 3; ++i)
      if ((p[i] | 0x20) != w[i]) return false;
    const char* q = skip_ws(p + 3, end);
    return q >= end || *q == ',' || *q == '\n' || *q == '\r';
  };
  return tok3("nan") || tok3("inf");
}

}  // namespace

extern "C" {

// ---- libsvm ----------------------------------------------------------
// Pass 1: count rows/entries and find max feature index.
// Returns 0 on success.
int fp_libsvm_dims(const char* path, int64_t* n_rows, int64_t* n_entries,
                   int64_t* max_col, int32_t* has_qid) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* p = m.data;
  const char* end = m.data + m.size;
  int64_t rows = 0, entries = 0, maxc = -1;
  *has_qid = 0;
  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '\n') {
      ++p;
      continue;
    }
    if (*p == '#') {
      while (p < end && *p != '\n') ++p;
      continue;
    }
    // label
    float lbl;
    const char* before = p;
    p = scan_float(p, end, &lbl);
    if (p == before) {  // malformed label: skip token, drop the line
      p = skip_token(p, end);
      while (p < end && *p != '\n') ++p;
      continue;
    }
    ++rows;
    // features until newline
    while (p < end && *p != '\n') {
      p = skip_ws(p, end);
      if (p >= end || *p == '\n' || *p == '#') {
        if (p < end && *p == '#')
          while (p < end && *p != '\n') ++p;
        break;
      }
      if (strncmp(p, "qid:", 4) == 0) {
        p += 4;
        long q;
        p = scan_int(p, end, &q);
        *has_qid = 1;
        continue;
      }
      before = p;
      long idx;
      p = scan_int(p, end, &idx);
      if (p < end && *p == ':') {
        ++p;
        float v;
        const char* vb = p;
        p = scan_float(p, end, &v);
        if (p == vb) p = skip_token(p, end);  // malformed value
        else {
          ++entries;
          if (idx > maxc) maxc = idx;
        }
      } else if (p == before) {
        p = skip_token(p, end);  // non-numeric junk: always make progress
      }
    }
  }
  *n_rows = rows;
  *n_entries = entries;
  *max_col = maxc;
  unmap(m);
  return 0;
}

// Pass 2: fill COO triplets + labels (+qids when present). Capacities from
// the dims pass bound every write — if the file changed in between, excess
// content is dropped rather than overrunning the caller's buffers.
int fp_libsvm_parse(const char* path, int64_t* row_idx, int32_t* col_idx,
                    float* values, float* labels, int64_t* qids,
                    int64_t cap_rows, int64_t cap_entries) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* p = m.data;
  const char* end = m.data + m.size;
  int64_t r = -1, e = 0;
  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '\n') {
      ++p;
      continue;
    }
    if (*p == '#') {
      while (p < end && *p != '\n') ++p;
      continue;
    }
    float lbl;
    const char* before = p;
    p = scan_float(p, end, &lbl);
    if (p == before) {
      p = skip_token(p, end);
      while (p < end && *p != '\n') ++p;
      continue;
    }
    if (r + 1 >= cap_rows) break;
    labels[++r] = lbl;
    if (qids) qids[r] = 0;
    while (p < end && *p != '\n') {
      p = skip_ws(p, end);
      if (p >= end || *p == '\n' || *p == '#') {
        if (p < end && *p == '#')
          while (p < end && *p != '\n') ++p;
        break;
      }
      if (strncmp(p, "qid:", 4) == 0) {
        p += 4;
        long q;
        p = scan_int(p, end, &q);
        if (qids) qids[r] = q;
        continue;
      }
      before = p;
      long idx;
      p = scan_int(p, end, &idx);
      if (p < end && *p == ':') {
        ++p;
        float v;
        const char* vb = p;
        p = scan_float(p, end, &v);
        if (p == vb) {
          p = skip_token(p, end);
        } else if (e < cap_entries) {
          row_idx[e] = r;
          col_idx[e] = static_cast<int32_t>(idx);
          values[e] = v;
          ++e;
        }
      } else if (p == before) {
        p = skip_token(p, end);
      }
    }
  }
  unmap(m);
  return 0;
}

// ---- CSV -------------------------------------------------------------
int fp_csv_dims(const char* path, int64_t* n_rows, int64_t* n_cols) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* p = m.data;
  const char* end = m.data + m.size;
  int64_t rows = 0, cols = 0;
  while (p < end) {
    while (p < end && *p == '\n') ++p;
    if (p >= end) break;
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    if (csv_data_line(p, line_end)) {
      if (cols == 0) {  // first data line determines column count
        int64_t c = 1;
        for (const char* q = p; q < line_end; ++q)
          if (*q == ',') ++c;
        cols = c;
      }
      ++rows;
    }
    p = line_end;
  }
  *n_rows = rows;
  *n_cols = cols;
  unmap(m);
  return 0;
}

// Dense row-major fill; empty fields -> NaN; header/comment lines skipped
// (must mirror fp_csv_dims's line acceptance).
int fp_csv_parse(const char* path, float* out, int64_t n_rows, int64_t n_cols) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* p = m.data;
  const char* end = m.data + m.size;
  int64_t r = 0;
  while (p < end && r < n_rows) {
    while (p < end && *p == '\n') ++p;
    if (p >= end) break;
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    if (!csv_data_line(p, line_end)) {
      p = line_end;
      continue;
    }
    for (int64_t c = 0; c < n_cols; ++c) {
      p = skip_ws(p, line_end);
      if (p >= line_end || *p == ',') {
        out[r * n_cols + c] = NAN;  // empty field
      } else {
        float v;
        const char* vb = p;
        p = scan_float(p, line_end, &v);
        if (p == vb) {
          v = NAN;
          p = skip_token(p, line_end);
        }
        out[r * n_cols + c] = v;
      }
      p = skip_ws(p, line_end);
      if (p < line_end && *p == ',') ++p;
    }
    p = line_end;
    ++r;
  }
  unmap(m);
  return 0;
}

}  // extern "C"
