// Native host runtime: streaming RGB-D frame source with prefetch.
//
// The reference's host layer (Kinect/SingleKinect OpenNI acquisition,
// cv::FileStorage XML depth IO, main.cpp frame staging) is C++; this is its
// TPU-framework equivalent: a background-threaded frame ring that decodes
// depth frames (OpenCV FileStorage XML subset or raw f32 .bin) and serves
// zero-copy host buffers ready for device upload, so the accelerator never
// waits on file IO.  Bound to Python via ctypes (see native/__init__.py);
// no pybind11 dependency.
//
// C API (all functions return 0 on success, negative on error):
//   fs_open(paths, n, width, height, capacity) -> handle
//   fs_next(handle, float* out, int timeout_ms)   blocking pop (round-robin)
//   fs_depth_xml_read(path, name, float* out, w, h)   one-shot XML read
//   fs_close(handle)

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <mutex>
#include <queue>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- XML read

// Minimal parser for the cv::FileStorage XML subset written by the reference
// (main.cpp:112-115) and by core/io.py: <name type_id="opencv-matrix"> with
// <rows>, <cols>, <dt>, whitespace-separated <data>.
bool read_matrix_xml(const std::string& path, const std::string& name,
                     float* out, int width, int height) {
  std::ifstream f(path);
  if (!f) return false;
  std::stringstream ss;
  ss << f.rdbuf();
  std::string s = ss.str();

  std::string open_tag = "<" + name;
  size_t node = s.find(open_tag);
  if (node == std::string::npos) return false;
  size_t data = s.find("<data>", node);
  if (data == std::string::npos) return false;
  size_t end = s.find("</data>", data);
  if (end == std::string::npos) return false;

  const char* p = s.c_str() + data + 6;
  const char* stop = s.c_str() + end;
  long total = static_cast<long>(width) * height;
  for (long i = 0; i < total; ++i) {
    char* next = nullptr;
    while (p < stop && (*p == ' ' || *p == '\n' || *p == '\t' || *p == '\r'))
      ++p;
    if (p >= stop) return false;
    out[i] = strtof(p, &next);
    if (next == p) return false;
    p = next;
  }
  return true;
}

bool read_raw_bin(const std::string& path, float* out, int width, int height) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  f.read(reinterpret_cast<char*>(out),
         static_cast<std::streamsize>(sizeof(float)) * width * height);
  return f.gcount() ==
         static_cast<std::streamsize>(sizeof(float)) * width * height;
}

bool load_frame(const std::string& path, float* out, int w, int h) {
  if (path.size() > 4 && path.substr(path.size() - 4) == ".xml")
    return read_matrix_xml(path, "depth", out, w, h);
  return read_raw_bin(path, out, w, h);
}

// ------------------------------------------------------------- frame ring

struct FrameRing {
  int width = 0, height = 0;
  std::vector<std::string> paths;
  std::queue<std::vector<float>> ready;
  size_t capacity = 4;
  size_t next_path = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::atomic<bool> stop{false};
  std::atomic<int> io_errors{0};
  std::thread worker;

  void run() {
    while (!stop.load()) {
      std::vector<float> buf(static_cast<size_t>(width) * height);
      std::string path;
      {
        std::lock_guard<std::mutex> l(mu);
        if (paths.empty()) return;
        path = paths[next_path];
        next_path = (next_path + 1) % paths.size();
      }
      if (!load_frame(path, buf.data(), width, height)) {
        io_errors.fetch_add(1);
        continue;
      }
      std::unique_lock<std::mutex> l(mu);
      cv_space.wait(l, [&] { return ready.size() < capacity || stop.load(); });
      if (stop.load()) return;
      ready.push(std::move(buf));
      cv_ready.notify_one();
    }
  }
};

std::mutex g_mu;
std::vector<FrameRing*> g_rings;

}  // namespace

extern "C" {

// paths: '\n'-joined file list.
long long fs_open(const char* paths, int width, int height, int capacity) {
  auto* ring = new FrameRing();
  ring->width = width;
  ring->height = height;
  ring->capacity = capacity > 0 ? static_cast<size_t>(capacity) : 4;
  std::stringstream ss(paths);
  std::string line;
  while (std::getline(ss, line, '\n'))
    if (!line.empty()) ring->paths.push_back(line);
  if (ring->paths.empty()) {
    delete ring;
    return -1;
  }
  ring->worker = std::thread([ring] { ring->run(); });
  std::lock_guard<std::mutex> l(g_mu);
  g_rings.push_back(ring);
  return reinterpret_cast<long long>(ring);
}

int fs_next(long long handle, float* out, int timeout_ms) {
  auto* ring = reinterpret_cast<FrameRing*>(handle);
  if (!ring) return -1;
  std::unique_lock<std::mutex> l(ring->mu);
  bool ok = ring->cv_ready.wait_for(
      l, std::chrono::milliseconds(timeout_ms > 0 ? timeout_ms : 10000),
      [&] { return !ring->ready.empty(); });
  if (!ok) return -2;
  std::vector<float> buf = std::move(ring->ready.front());
  ring->ready.pop();
  ring->cv_space.notify_one();
  l.unlock();
  std::memcpy(out, buf.data(), buf.size() * sizeof(float));
  return 0;
}

int fs_io_errors(long long handle) {
  auto* ring = reinterpret_cast<FrameRing*>(handle);
  return ring ? ring->io_errors.load() : -1;
}

int fs_close(long long handle) {
  auto* ring = reinterpret_cast<FrameRing*>(handle);
  if (!ring) return -1;
  ring->stop.store(true);
  ring->cv_space.notify_all();
  ring->cv_ready.notify_all();
  if (ring->worker.joinable()) ring->worker.join();
  {
    std::lock_guard<std::mutex> l(g_mu);
    for (auto it = g_rings.begin(); it != g_rings.end(); ++it)
      if (*it == ring) {
        g_rings.erase(it);
        break;
      }
  }
  delete ring;
  return 0;
}

int fs_depth_xml_read(const char* path, const char* name, float* out, int width,
                      int height) {
  return read_matrix_xml(path, name, out, width, height) ? 0 : -1;
}

}  // extern "C"
