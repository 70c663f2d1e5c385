// Bounded MPMC channel — the back-pressure primitive of the stream
// pipeline (rebuild of the reference's src/channel.hpp [MED;
// empty reference mount — see SURVEY.md]; written from scratch).
#pragma once

#include <condition_variable>
#include <cstddef>
#include <deque>
#include <mutex>
#include <optional>

namespace pose_host {

template <typename T>
class Channel {
 public:
  explicit Channel(std::size_t capacity) : capacity_(capacity) {}

  // Blocks while full. Returns false if the channel was closed.
  bool push(T value) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_push_.wait(lk, [&] { return closed_ || q_.size() < capacity_; });
    if (closed_) return false;
    q_.push_back(std::move(value));
    cv_pop_.notify_one();
    return true;
  }

  // Blocks while empty. Empty optional once closed and drained.
  std::optional<T> pop() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_pop_.wait(lk, [&] { return closed_ || !q_.empty(); });
    if (q_.empty()) return std::nullopt;
    T v = std::move(q_.front());
    q_.pop_front();
    cv_push_.notify_one();
    return v;
  }

  void close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    cv_push_.notify_all();
    cv_pop_.notify_all();
  }

  std::size_t size() const {
    std::lock_guard<std::mutex> lk(mu_);
    return q_.size();
  }

 private:
  mutable std::mutex mu_;
  std::condition_variable cv_push_, cv_pop_;
  std::deque<T> q_;
  std::size_t capacity_;
  bool closed_ = false;
};

}  // namespace pose_host
