// fastcsv — native numeric-CSV parser for the host data path (the
// PyTorch port's own copy of dist_keras_tpu/data/native/fastcsv.cpp).
//
// Role: the reference feeds training data through Spark's CSV reader into
// DataFrames; our host-side equivalent parses numeric CSVs straight into a
// caller-provided (numpy-preallocated) float32 matrix.  The file is read
// ONCE into a buffer; a single scan indexes the [begin, end) byte range of
// every non-blank data line (so dims and parse can never disagree, and a
// file growing between calls cannot overflow); value parsing is then
// row-parallel with std::thread, each row hard-bounded to its own line
// range and output slot.
//
// C ABI (ctypes) — two-call, opaque-handle, zero-copy:
//   void* fastcsv_scan(const char* path, int has_header,
//                      long long* rows, long long* cols);
//     -> reads + indexes the file; returns a handle (NULL on error) and
//        the dims the caller should allocate.
//   int fastcsv_extract(void* handle, float* out,
//                       long long rows, long long cols);
//     -> parses into the caller's rows*cols float32 buffer, bounded by
//        BOTH the handle's index and the caller's dims; frees the handle.
//        Returns 0 on success, negative error codes otherwise.
//   void fastcsv_release(void* handle);
//     -> frees a handle without extracting (error-path cleanup).
// All entry points catch C++ exceptions (bad_alloc etc.) — nothing ever
// unwinds across the ctypes boundary.

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ScanHandle {
  std::string buf;                // entire file (+ sentinel newline)
  std::vector<size_t> begins;     // per non-blank data line
  std::vector<size_t> ends;
  long long cols = 0;
};

// Read the whole file into a string (with trailing sentinel newline).
static int read_file(const char* path, std::string& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (std::fseek(f, 0, SEEK_END) != 0) {
    std::fclose(f);
    return -1;
  }
  long size = std::ftell(f);
  if (size < 0) {
    std::fclose(f);
    return -1;
  }
  std::fseek(f, 0, SEEK_SET);
  buf.resize(static_cast<size_t>(size));
  if (size > 0 && std::fread(&buf[0], 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);
  if (buf.empty() || buf.back() != '\n') buf.push_back('\n');
  return 0;
}

// Skip the header line, returning the offset of the first data byte.
static size_t data_start(const std::string& buf, int has_header) {
  if (!has_header) return 0;
  size_t p = buf.find('\n');
  return p == std::string::npos ? buf.size() : p + 1;
}

// One pass over the buffer: record [begin, end) of every non-blank data
// line (blank = only \r/space/tab, matching the numpy fallback's
// blank-line skip) and the column count from the first data line.  This
// index is the single source of truth for both row count and parse
// targets — a two-call dims/parse API over separate reads could
// desynchronize on blank lines and on files modified between the calls.
static void scan_lines(const std::string& buf, int has_header,
                       std::vector<size_t>& begins, std::vector<size_t>& ends,
                       long long& cols) {
  cols = 0;
  size_t i = data_start(buf, has_header);
  const size_t n = buf.size();
  while (i < n) {
    size_t eol = buf.find('\n', i);
    if (eol == std::string::npos) eol = n;  // unreachable: sentinel newline
    bool blank = true;
    for (size_t j = i; j < eol; ++j) {
      if (buf[j] != '\r' && buf[j] != ' ' && buf[j] != '\t') {
        blank = false;
        break;
      }
    }
    if (!blank) {
      if (cols == 0) {
        cols = 1;
        for (size_t j = i; j < eol; ++j)
          if (buf[j] == ',') ++cols;
      }
      begins.push_back(i);
      ends.push_back(eol);
    }
    i = eol + 1;
  }
}

// Parse rows [r0, r1), reading at most `cols` values per row and writing
// rows at `out_stride` floats apart.  Every read stays inside the row's
// recorded [begin, end) line range and every write inside its cols-wide
// output slot; short/ragged lines fill 0 rather than running into a
// neighbor.
static void parse_rows(const char* base, const size_t* begins,
                       const size_t* ends, long long r0, long long r1,
                       float* out, long long cols, long long out_stride) {
  for (long long r = r0; r < r1; ++r) {
    const char* p = base + begins[r];
    const char* stop = base + ends[r];
    float* dst = out + r * out_stride;
    for (long long c = 0; c < cols; ++c) {
      while (p < stop && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
      float v = 0.0f;
      if (p < stop && *p != ',') {
        char* next = nullptr;
        float parsed = std::strtof(p, &next);
        // A numeric token never contains '\n', so next <= stop whenever
        // the token starts before stop; the guard is belt-and-braces.
        if (next && next > p && next <= stop) {
          v = parsed;
          p = next;
        }
      }
      dst[c] = v;
      while (p < stop && *p != ',') ++p;  // tolerate ragged tails
      if (p < stop) ++p;                  // consume separator
    }
  }
}

}  // namespace

extern "C" {

void* fastcsv_scan(const char* path, int has_header, long long* rows,
                   long long* cols) {
  if (!path || !rows || !cols) return nullptr;
  *rows = 0;
  *cols = 0;
  try {
    ScanHandle* h = new ScanHandle();
    if (read_file(path, h->buf) != 0) {
      delete h;
      return nullptr;
    }
    scan_lines(h->buf, has_header, h->begins, h->ends, h->cols);
    *rows = static_cast<long long>(h->begins.size());
    *cols = h->cols;
    return h;
  } catch (...) {
    return nullptr;  // bad_alloc / length_error: caller falls back to numpy
  }
}

int fastcsv_extract(void* handle, float* out, long long rows,
                    long long cols) {
  ScanHandle* h = static_cast<ScanHandle*>(handle);
  if (!h) return -3;
  if (!out || rows < 0 || cols < 0) {
    delete h;
    return -3;
  }
  try {
    // Bound by both the caller's allocation and the scan index.
    const long long nrows =
        std::min<long long>(rows, static_cast<long long>(h->begins.size()));
    const long long ncols = std::min<long long>(cols, h->cols);
    if (nrows > 0 && ncols > 0) {
      if (ncols < cols || nrows < rows)
        std::memset(out, 0, sizeof(float) * rows * cols);
      unsigned n_threads = std::thread::hardware_concurrency();
      if (n_threads == 0) n_threads = 1;
      if (static_cast<long long>(n_threads) > nrows)
        n_threads = static_cast<unsigned>(nrows);
      std::vector<std::thread> threads;
      const long long per = (nrows + n_threads - 1) / n_threads;
      for (unsigned t = 0; t < n_threads; ++t) {
        const long long r0 = static_cast<long long>(t) * per;
        const long long r1 = std::min(nrows, r0 + per);
        if (r0 >= r1) break;
        threads.emplace_back(parse_rows, h->buf.data(), h->begins.data(),
                             h->ends.data(), r0, r1, out, ncols, cols);
      }
      for (auto& th : threads) th.join();
    }
    delete h;
    return 0;
  } catch (...) {
    delete h;
    return -5;
  }
}

void fastcsv_release(void* handle) {
  delete static_cast<ScanHandle*>(handle);
}

}  // extern "C"
