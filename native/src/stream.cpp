// Pipelined stream loader + C API for ctypes binding.
//
// Rebuild of the reference's stream pipeline host side
// (src/stream_detector.cpp + thread_pool [MED; empty reference mount —
// SURVEY.md §2 "Stream detector"]): worker threads decode+letterbox frames
// into ready uint8 batches behind a bounded channel; on device the DNN AND
// the grouping run inside one jit graph, so decode/resize is the only
// host stage left to pipeline (the reference needed three stages because
// its PAF parser ran on the host).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <thread>
#include <vector>

#include "pose_host/channel.hpp"
#include "pose_host/image.hpp"
#include "pose_host/tracer.hpp"

namespace pose_host {
namespace {

struct Frame {
  int index = -1;                    // source position (for ordering/meta)
  std::vector<std::uint8_t> pixels;  // (hin, win, 3)
  float scale = 1.0f;
  float pad[2] = {0.0f, 0.0f};
  bool ok = false;
};

struct Batch {
  std::vector<Frame> frames;
};

class StreamLoader {
 public:
  // s2d_level: 0 = plain HWC, 1 = space-to-depth (needs even dims),
  // 2 = space-to-depth squared (needs dims % 4 == 0); demoted when the
  // geometry does not allow the requested level.
  StreamLoader(std::vector<std::string> paths, int hin, int win, int batch,
               int workers, int queue_capacity, bool loop, int s2d_level)
      : paths_(std::move(paths)), hin_(hin), win_(win), batch_(batch),
        loop_(loop),
        s2d_(s2d_level >= 2 && hin % 4 == 0 && win % 4 == 0
                 ? 2
                 : (s2d_level >= 1 && hin % 2 == 0 && win % 2 == 0 ? 1 : 0)),
        n_workers_(workers),
        frames_(queue_capacity * std::max(batch, 1)),
        batches_(queue_capacity) {
    // n_workers_ is fixed BEFORE spawning: a fast worker finishing while
    // the constructor is still emplacing threads must not see a short
    // workers_.size() and close the frame channel early (drops frames).
    for (int w = 0; w < workers; ++w)
      workers_.emplace_back([this] { decode_worker(); });
    collector_ = std::thread([this] { collect_worker(); });
  }

  ~StreamLoader() { stop(); }

  void stop() {
    stopping_ = true;
    frames_.close();
    batches_.close();
    for (auto& t : workers_)
      if (t.joinable()) t.join();
    if (collector_.joinable()) collector_.join();
  }

  int s2d_level() const { return s2d_; }

  // Returns frames copied into out (0 at end of stream).
  int next(std::uint8_t* out_pixels, float* out_scales, float* out_pads,
           std::int32_t* out_indices) {
    auto b = batches_.pop();
    if (!b) return 0;
    const std::size_t frame_bytes = std::size_t(hin_) * win_ * 3;
    int n = 0;
    for (auto& f : b->frames) {
      std::memcpy(out_pixels + n * frame_bytes, f.pixels.data(), frame_bytes);
      out_scales[n] = f.scale;
      out_pads[2 * n] = f.pad[0];
      out_pads[2 * n + 1] = f.pad[1];
      out_indices[n] = f.index;
      ++n;
    }
    return n;
  }

 private:
  void decode_worker() {
    while (!stopping_) {
      const std::size_t i = next_index_.fetch_add(1);
      if (i >= paths_.size() && !loop_) break;
      const std::size_t idx = loop_ ? i % paths_.size() : i;
      Frame f;
      f.index = static_cast<int>(idx);
      f.pixels.resize(std::size_t(hin_) * win_ * 3);
      Image img;
      if (decode_image(paths_[idx].c_str(), &img, hin_, win_)) {
        if (s2d_) {
          // letterbox into a per-thread scratch plane, then emit the
          // engine's space-to-depth layout (same bytes, block-permuted)
          thread_local std::vector<std::uint8_t> scratch;
          scratch.resize(f.pixels.size());
          letterbox_resize(img, hin_, win_, scratch.data(), &f.scale, f.pad);
          if (s2d_ == 2)
            space_to_depth2_u8(scratch.data(), hin_, win_, f.pixels.data());
          else
            space_to_depth_u8(scratch.data(), hin_, win_, f.pixels.data());
        } else {
          letterbox_resize(img, hin_, win_, f.pixels.data(), &f.scale, f.pad);
        }
        f.ok = true;
      }
      if (!frames_.push(std::move(f))) break;
    }
    if (++workers_done_ == n_workers_) frames_.close();
  }

  void collect_worker() {
    Batch b;
    while (true) {
      auto f = frames_.pop();
      if (!f) break;
      if (!f->ok) continue;  // unreadable file: skip
      b.frames.push_back(std::move(*f));
      if (static_cast<int>(b.frames.size()) == batch_) {
        if (!batches_.push(std::move(b))) return;
        b = Batch{};
      }
    }
    if (!b.frames.empty()) batches_.push(std::move(b));
    batches_.close();
  }

  std::vector<std::string> paths_;
  int hin_, win_, batch_;
  bool loop_;
  int s2d_;
  int n_workers_;
  std::atomic<std::size_t> next_index_{0};
  std::atomic<int> workers_done_{0};
  std::atomic<bool> stopping_{false};
  Channel<Frame> frames_;
  Channel<Batch> batches_;
  std::vector<std::thread> workers_;
  std::thread collector_;
};

}  // namespace
}  // namespace pose_host

// ----------------------------------------------------------- C API -------

extern "C" {

void* ph_stream_create(const char** paths, int n_paths, int hin, int win,
                       int batch, int workers, int queue_capacity,
                       int loop) {
  std::vector<std::string> p(paths, paths + n_paths);
  return new pose_host::StreamLoader(std::move(p), hin, win, batch, workers,
                                     queue_capacity, loop != 0, false);
}

// v2: adds the s2d level — frames are emitted in the engine's
// space-to-depth layout: level 1 = (hin/2, win/2, 12), level 2 =
// (hin/4, win/4, 48). Separate symbol so a stale prebuilt .so keeps
// working with the old binding.
void* ph_stream_create2(const char** paths, int n_paths, int hin, int win,
                        int batch, int workers, int queue_capacity, int loop,
                        int s2d_level) {
  std::vector<std::string> p(paths, paths + n_paths);
  return new pose_host::StreamLoader(std::move(p), hin, win, batch, workers,
                                     queue_capacity, loop != 0, s2d_level);
}

// Standalone space-to-depth for letterboxed frames already in memory.
void ph_s2d_u8(const std::uint8_t* src, int h, int w, std::uint8_t* dst) {
  pose_host::space_to_depth_u8(src, h, w, dst);
}

void ph_s2d2_u8(const std::uint8_t* src, int h, int w, std::uint8_t* dst) {
  pose_host::space_to_depth2_u8(src, h, w, dst);
}

// Effective space-to-depth level the loader will emit (after geometry
// demotion) — the binding reads this back instead of re-deriving the
// demotion rules, so the buffer-shape contract has one source of truth.
int ph_stream_level(void* handle) {
  return static_cast<pose_host::StreamLoader*>(handle)->s2d_level();
}

int ph_stream_next(void* handle, std::uint8_t* out_pixels, float* out_scales,
                   float* out_pads, std::int32_t* out_indices) {
  return static_cast<pose_host::StreamLoader*>(handle)->next(
      out_pixels, out_scales, out_pads, out_indices);
}

void ph_stream_destroy(void* handle) {
  delete static_cast<pose_host::StreamLoader*>(handle);
}

// Single image: decode + letterbox. Returns 1 on success.
int ph_load_image(const char* path, int hin, int win, std::uint8_t* out,
                  float* scale_out, float* pad_out) {
  pose_host::Image img;
  if (!pose_host::decode_image(path, &img, hin, win)) return 0;
  pose_host::letterbox_resize(img, hin, win, out, scale_out, pad_out);
  return 1;
}

// Raw-frame letterbox (camera/video frames already in memory).
void ph_letterbox(const std::uint8_t* rgb, int h, int w, int hin, int win,
                  std::uint8_t* out, float* scale_out, float* pad_out) {
  pose_host::Image img;
  img.w = w;
  img.h = h;
  img.rgb.assign(rgb, rgb + std::size_t(h) * w * 3);
  pose_host::letterbox_resize(img, hin, win, out, scale_out, pad_out);
}

static thread_local std::string g_report;

const char* ph_tracer_report() {
  g_report = pose_host::Tracer::instance().report();
  return g_report.c_str();
}

void ph_tracer_reset() { pose_host::Tracer::instance().reset(); }

}  // extern "C"
