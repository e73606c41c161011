// wast3d_tpu_torch native IO: fast PLY vertex + COLMAP binary readers.
//
// The port's own copy of wast3d_tpu/native/io.cpp, with the same C ABI.
// Host-side data-loading fast path: the numpy readers in scene/ply.py and
// scene/colmap.py stay as the portable fallback. Million-splat Gaussian
// PLYs are ~250MB; this reads them with one buffered pass and no per-row
// Python object churn.
//
// C ABI only (loaded via ctypes). Built with jpeg.cpp into one library by
// wast3d_tpu_torch/_build.py::build_native (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// Parse a binary_little_endian PLY whose vertex properties are all f4.
// Returns 0 on success; fills rows/cols and copies row-major f32 data
// into out (caller allocates max_floats). Negative error codes:
// -1 open, -2 header, -3 not all-float, -4 buffer too small, -5 short read.
int w3d_read_ply_f32(const char* path, float* out, int64_t max_floats,
                     int64_t* rows, int64_t* cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  std::string header;
  header.reserve(1 << 16);
  // Read header line by line; terminate only on a line that IS exactly
  // "end_header" (not a substring match — a comment mentioning
  // end_header must not truncate the scan; mirrors scene/ply.py).
  int c;
  size_t line_start = 0;
  bool done = false;
  while (!done && (c = fgetc(f)) != EOF) {
    header.push_back(static_cast<char>(c));
    if (c == '\n') {
      size_t line_end = header.size() - 1;  // exclude '\n'
      if (line_end > line_start && header[line_end - 1] == '\r') line_end--;
      if (header.compare(line_start, line_end - line_start, "end_header") == 0 &&
          line_end - line_start == 10)
        done = true;
      line_start = header.size();
    }
    if (header.size() > (1u << 20)) { fclose(f); return -2; }
  }
  if (!done) { fclose(f); return -2; }
  if (header.find("format binary_little_endian") == std::string::npos) {
    fclose(f);
    return -2;
  }
  int64_t n = -1, nprops = 0;
  size_t p = 0;
  while (p < header.size()) {
    size_t e = header.find('\n', p);
    if (e == std::string::npos) e = header.size();
    std::string line = header.substr(p, e - p);
    p = e + 1;
    if (line.rfind("element vertex ", 0) == 0) {
      n = strtoll(line.c_str() + 15, nullptr, 10);
    } else if (line.rfind("property ", 0) == 0) {
      if (line.rfind("property float ", 0) != 0 &&
          line.rfind("property float32 ", 0) != 0) {
        fclose(f);
        return -3;
      }
      nprops++;
    }
  }
  if (n < 0 || nprops <= 0) { fclose(f); return -2; }
  int64_t total = n * nprops;
  if (total > max_floats) { fclose(f); return -4; }
  int64_t got = static_cast<int64_t>(fread(out, sizeof(float), total, f));
  fclose(f);
  if (got != total) return -5;
  *rows = n;
  *cols = nprops;
  return 0;
}

// Write header (ascii, caller-composed, must end with "end_header\n")
// followed by row-major f32 data. Returns 0 on success.
int w3d_write_ply_f32(const char* path, const char* header, const float* data,
                      int64_t rows, int64_t cols) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  size_t hl = strlen(header);
  if (fwrite(header, 1, hl, f) != hl) { fclose(f); return -5; }
  int64_t total = rows * cols;
  if (static_cast<int64_t>(fwrite(data, sizeof(float), total, f)) != total) {
    fclose(f);
    return -5;
  }
  fclose(f);
  return 0;
}

// COLMAP points3D.bin: fills xyz (n*3 doubles) and rgb (n*3 bytes).
// Returns 0 on success, fills out_n. -4 if more points than max_pts.
int w3d_read_colmap_points3d(const char* path, double* xyz, uint8_t* rgb,
                             int64_t max_pts, int64_t* out_n) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint64_t n;
  if (fread(&n, 8, 1, f) != 1) { fclose(f); return -5; }
  if (static_cast<int64_t>(n) > max_pts) { fclose(f); return -4; }
  for (uint64_t i = 0; i < n; i++) {
    uint64_t id;
    if (fread(&id, 8, 1, f) != 1) { fclose(f); return -5; }
    if (fread(xyz + 3 * i, 8, 3, f) != 3) { fclose(f); return -5; }
    if (fread(rgb + 3 * i, 1, 3, f) != 3) { fclose(f); return -5; }
    double err;
    if (fread(&err, 8, 1, f) != 1) { fclose(f); return -5; }
    uint64_t track_len;
    if (fread(&track_len, 8, 1, f) != 1) { fclose(f); return -5; }
    if (fseek(f, static_cast<long>(8 * track_len), SEEK_CUR) != 0) {
      fclose(f);
      return -5;
    }
  }
  fclose(f);
  *out_n = static_cast<int64_t>(n);
  return 0;
}

}  // extern "C"
