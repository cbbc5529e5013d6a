// Native runtime support for direct_stereo_slam_tpu.
//
// The reference's ingestion path is C++ (ROS node + rosbag reading +
// cv_bridge + DSO Undistort, reference src/main.cpp:212-265); this library
// is its JAX-framework counterpart: image decoding (PGM/PPM), the fused
// photometric-LUT + bilinear-remap undistortion (DSO
// Undistort::undistort<uchar> + photometricUndist), and a threaded
// prefetching frame queue so disk IO and preprocessing overlap device
// compute. Bound from Python via ctypes (io/native.py).
//
// Build: make -C native   (g++ -O3 -shared, no external dependencies)

#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PGM/PPM decoding (P5/P6 binary)
// ---------------------------------------------------------------------------

// Parses header, returns 0 on success; fills w, h, channels and copies pixel
// bytes (8-bit) into out (caller allocates w*h*channels after probing).
int pnm_probe(const char* path, int* w, int* h, int* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char magic[3] = {0};
  if (fscanf(f, "%2s", magic) != 1) { fclose(f); return -2; }
  int c;
  // skip whitespace/comments
  auto skip = [&]() {
    while ((c = fgetc(f)) != EOF) {
      if (c == '#') { while ((c = fgetc(f)) != EOF && c != '\n') {} }
      else if (!isspace(c)) { ungetc(c, f); break; }
    }
  };
  int width, height, maxval;
  skip(); if (fscanf(f, "%d", &width) != 1) { fclose(f); return -3; }
  skip(); if (fscanf(f, "%d", &height) != 1) { fclose(f); return -3; }
  skip(); if (fscanf(f, "%d", &maxval) != 1) { fclose(f); return -3; }
  fclose(f);
  if (strcmp(magic, "P5") == 0) *channels = 1;
  else if (strcmp(magic, "P6") == 0) *channels = 3;
  else return -4;
  *w = width; *h = height;
  return 0;
}

int pnm_read(const char* path, uint8_t* out, int out_size) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char magic[3] = {0};
  if (fscanf(f, "%2s", magic) != 1) { fclose(f); return -2; }
  int c;
  auto skip = [&]() {
    while ((c = fgetc(f)) != EOF) {
      if (c == '#') { while ((c = fgetc(f)) != EOF && c != '\n') {} }
      else if (!isspace(c)) { ungetc(c, f); break; }
    }
  };
  int width, height, maxval;
  skip(); fscanf(f, "%d", &width);
  skip(); fscanf(f, "%d", &height);
  skip(); fscanf(f, "%d", &maxval);
  fgetc(f);  // single whitespace after maxval
  int channels = (strcmp(magic, "P6") == 0) ? 3 : 1;
  long need = (long)width * height * channels;
  if (need > out_size) { fclose(f); return -5; }
  size_t got = fread(out, 1, need, f);
  fclose(f);
  return got == (size_t)need ? 0 : -6;
}

// ---------------------------------------------------------------------------
// Fused undistortion: u8 -> gamma LUT -> bilinear remap -> float32
// (DSO Undistort::undistort + photometricUndist in one pass)
// ---------------------------------------------------------------------------

static void undistort_rows(const uint8_t* src, int in_w, int in_h,
                           const float* lut,       // 256 or nullptr
                           const float* map_x,     // [out_h*out_w]
                           const float* map_y,
                           float* out, int out_w,
                           int row0, int row1) {
  for (int v = row0; v < row1; v++) {
    for (int u = 0; u < out_w; u++) {
      int i = v * out_w + u;
      float sx = map_x[i], sy = map_y[i];
      if (sx < 0.f || sy < 0.f) { out[i] = 0.f; continue; }
      int ix = (int)sx, iy = (int)sy;
      if (ix >= in_w - 1) ix = in_w - 2;
      if (iy >= in_h - 1) iy = in_h - 2;
      float fx = sx - ix, fy = sy - iy;
      const uint8_t* p = src + iy * in_w + ix;
      float p00 = p[0], p10 = p[1], p01 = p[in_w], p11 = p[in_w + 1];
      if (lut) {
        p00 = lut[(int)p00]; p10 = lut[(int)p10];
        p01 = lut[(int)p01]; p11 = lut[(int)p11];
      }
      float top = p00 + fx * (p10 - p00);
      float bot = p01 + fx * (p11 - p01);
      out[i] = top + fy * (bot - top);
    }
  }
}

void undistort_u8(const uint8_t* src, int in_w, int in_h,
                  const float* lut,
                  const float* map_x, const float* map_y,
                  float* out, int out_w, int out_h, int n_threads) {
  if (n_threads <= 1) {
    undistort_rows(src, in_w, in_h, lut, map_x, map_y, out, out_w, 0, out_h);
    return;
  }
  std::vector<std::thread> ts;
  int rows = (out_h + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    int r0 = t * rows, r1 = std::min(out_h, r0 + rows);
    if (r0 >= r1) break;
    ts.emplace_back(undistort_rows, src, in_w, in_h, lut, map_x, map_y,
                    out, out_w, r0, r1);
  }
  for (auto& t : ts) t.join();
}

// plain LUT application (identity geometry)
void apply_lut_u8(const uint8_t* src, int n, const float* lut, float* out) {
  for (int i = 0; i < n; i++) out[i] = lut[src[i]];
}

// ---------------------------------------------------------------------------
// Prefetching stereo frame queue
// ---------------------------------------------------------------------------

struct Frame {
  std::vector<float> img0, img1;
  double timestamp;
  int id;
};

struct FrameQueue {
  std::queue<Frame> q;
  std::mutex m;
  std::condition_variable cv_push, cv_pop;
  size_t capacity;
  std::atomic<bool> done{false};
  std::thread loader;
  int w = 0, h = 0;
};

struct LoaderSpec {
  std::vector<std::string> files0, files1;
  std::vector<double> stamps;
  const float* lut0; const float* lut1;
  const float* mapx0; const float* mapy0;
  const float* mapx1; const float* mapy1;
  int in_w, in_h, out_w, out_h;
  int n_threads;
};

static void loader_main(FrameQueue* fq, LoaderSpec spec) {
  std::vector<uint8_t> raw(spec.in_w * spec.in_h);
  for (size_t i = 0; i < spec.files0.size() && !fq->done.load(); i++) {
    Frame fr;
    fr.id = (int)i;
    fr.timestamp = spec.stamps[i];
    fr.img0.resize(spec.out_w * spec.out_h);
    fr.img1.resize(spec.out_w * spec.out_h);
    if (pnm_read(spec.files0[i].c_str(), raw.data(), (int)raw.size()) == 0)
      undistort_u8(raw.data(), spec.in_w, spec.in_h, spec.lut0,
                   spec.mapx0, spec.mapy0, fr.img0.data(),
                   spec.out_w, spec.out_h, spec.n_threads);
    if (pnm_read(spec.files1[i].c_str(), raw.data(), (int)raw.size()) == 0)
      undistort_u8(raw.data(), spec.in_w, spec.in_h, spec.lut1,
                   spec.mapx1, spec.mapy1, fr.img1.data(),
                   spec.out_w, spec.out_h, spec.n_threads);
    std::unique_lock<std::mutex> lk(fq->m);
    fq->cv_push.wait(lk, [&] { return fq->q.size() < fq->capacity || fq->done; });
    if (fq->done) break;
    fq->q.push(std::move(fr));
    fq->cv_pop.notify_one();
  }
  fq->done = true;
  fq->cv_pop.notify_all();
}

void* queue_create(int capacity) {
  auto* fq = new FrameQueue();
  fq->capacity = capacity;
  return fq;
}

// file lists passed as newline-joined strings; maps/luts are borrowed
// pointers that must outlive the queue (the Python wrapper keeps them alive)
void queue_start(void* h, const char* files0, const char* files1,
                 const double* stamps, int n,
                 const float* lut0, const float* lut1,
                 const float* mapx0, const float* mapy0,
                 const float* mapx1, const float* mapy1,
                 int in_w, int in_h, int out_w, int out_h, int n_threads) {
  auto* fq = (FrameQueue*)h;
  LoaderSpec spec;
  auto split = [](const char* s, std::vector<std::string>& out) {
    std::string cur;
    for (const char* p = s; *p; p++) {
      if (*p == '\n') { if (!cur.empty()) out.push_back(cur); cur.clear(); }
      else cur.push_back(*p);
    }
    if (!cur.empty()) out.push_back(cur);
  };
  split(files0, spec.files0);
  split(files1, spec.files1);
  spec.stamps.assign(stamps, stamps + n);
  spec.lut0 = lut0; spec.lut1 = lut1;
  spec.mapx0 = mapx0; spec.mapy0 = mapy0;
  spec.mapx1 = mapx1; spec.mapy1 = mapy1;
  spec.in_w = in_w; spec.in_h = in_h;
  spec.out_w = out_w; spec.out_h = out_h;
  spec.n_threads = n_threads;
  fq->w = out_w; fq->h = out_h;
  fq->loader = std::thread(loader_main, fq, std::move(spec));
}

// returns 1 on frame, 0 when exhausted
int queue_pop(void* h, float* img0, float* img1, double* timestamp, int* id) {
  auto* fq = (FrameQueue*)h;
  std::unique_lock<std::mutex> lk(fq->m);
  fq->cv_pop.wait(lk, [&] { return !fq->q.empty() || fq->done; });
  if (fq->q.empty()) return 0;
  Frame fr = std::move(fq->q.front());
  fq->q.pop();
  fq->cv_push.notify_one();
  lk.unlock();
  memcpy(img0, fr.img0.data(), fr.img0.size() * sizeof(float));
  memcpy(img1, fr.img1.data(), fr.img1.size() * sizeof(float));
  *timestamp = fr.timestamp;
  *id = fr.id;
  return 1;
}

void queue_destroy(void* h) {
  auto* fq = (FrameQueue*)h;
  fq->done = true;
  fq->cv_push.notify_all();
  fq->cv_pop.notify_all();
  if (fq->loader.joinable()) fq->loader.join();
  delete fq;
}

}  // extern "C"
