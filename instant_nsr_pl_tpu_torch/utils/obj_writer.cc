// The OBJ writer of utils/savers.py save_obj: the same bytes as its Python
// formatting ("v %.6f %.6f %.6f[ %.4f %.4f %.4f]" per vertex, "f %d %d %d"
// per face with 1-based indices, lines joined by "\n" and one "\n" at the
// end), written by threads that each format a contiguous range of lines.
// Built with g++ at first use and called through ctypes. printf's "%.6f" is
// correctly rounded, ties to even, as Python's float formatting; a NaN
// prints as "nan" whatever its sign bit, as Python prints it.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <string>
#include <thread>
#include <vector>

namespace {

void put_float(std::string& out, float v, const char* fmt) {
  if (std::isnan(v)) {
    out += "nan";
    return;
  }
  char buf[64];
  const int n = std::snprintf(buf, sizeof(buf), fmt, static_cast<double>(v));
  out.append(buf, static_cast<size_t>(n));
}

void put_int(std::string& out, int64_t v) {
  char buf[24];
  const int n = std::snprintf(buf, sizeof(buf), "%lld", static_cast<long long>(v));
  out.append(buf, static_cast<size_t>(n));
}

// lines [lo, hi) of the file: vertices first, then faces
void format_lines(std::string& out, const float* v, const float* rgb, int64_t nv,
                  const int64_t* f, int64_t lo, int64_t hi) {
  out.reserve(static_cast<size_t>(hi - lo) * (rgb != nullptr ? 64 : 40));
  for (int64_t i = lo; i < hi; ++i) {
    if (i < nv) {
      out += "v";
      for (int d = 0; d < 3; ++d) {
        out += ' ';
        put_float(out, v[3 * i + d], "%.6f");
      }
      if (rgb != nullptr) {
        for (int d = 0; d < 3; ++d) {
          out += ' ';
          put_float(out, rgb[3 * i + d], "%.4f");
        }
      }
    } else {
      const int64_t k = i - nv;
      out += "f";
      for (int d = 0; d < 3; ++d) {
        out += ' ';
        put_int(out, f[3 * k + d] + 1);
      }
    }
    out += '\n';
  }
}

}  // namespace

extern "C" {

// Write `nv` vertices (nv, 3) float32, their colours (nv, 3) float32 or
// nullptr, and `nf` faces (nf, 3) int64 (0-based) to `path`. Returns 0, or
// -1 when the file cannot be opened or written.
int64_t obj_write(const char* path, const float* v, const float* rgb, int64_t nv,
                  const int64_t* f, int64_t nf, int64_t threads) {
  const int64_t lines = nv + nf;
  FILE* fh = std::fopen(path, "wb");
  if (fh == nullptr) return -1;
  bool ok = true;
  if (lines == 0) {
    ok = std::fputs("\n", fh) >= 0;
  } else {
    const int64_t t = threads < 1 ? 1 : (threads > lines ? lines : threads);
    std::vector<std::string> parts(static_cast<size_t>(t));
    std::vector<std::thread> pool;
    for (int64_t k = 0; k < t; ++k) {
      pool.emplace_back(format_lines, std::ref(parts[k]), v, rgb, nv, f, lines * k / t,
                        lines * (k + 1) / t);
    }
    for (auto& th : pool) th.join();
    for (const auto& p : parts) ok = ok && std::fwrite(p.data(), 1, p.size(), fh) == p.size();
  }
  ok = std::fclose(fh) == 0 && ok;
  return ok ? 0 : -1;
}

}  // extern "C"
