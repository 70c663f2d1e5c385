// Fixed-size worker pool over a bounded task channel (rebuild
// of the reference's src/thread_pool.hpp [MED; empty reference mount —
// SURVEY.md §2]; written from scratch). The stream loader uses dedicated
// worker loops; this generic pool serves ad-hoc host-side parallelism
// (e.g. batched single-image preprocessing from bindings).
#pragma once

#include <functional>
#include <thread>
#include <vector>

#include "pose_host/channel.hpp"

namespace pose_host {

class ThreadPool {
 public:
  explicit ThreadPool(std::size_t n_threads, std::size_t queue_capacity = 64)
      : tasks_(queue_capacity) {
    workers_.reserve(n_threads);
    for (std::size_t i = 0; i < n_threads; ++i) {
      workers_.emplace_back([this] {
        while (auto task = tasks_.pop()) (*task)();
      });
    }
  }

  ~ThreadPool() {
    tasks_.close();
    for (auto& w : workers_)
      if (w.joinable()) w.join();
  }

  // Blocks while the queue is full; returns false after close().
  bool submit(std::function<void()> task) {
    return tasks_.push(std::move(task));
  }

 private:
  Channel<std::function<void()>> tasks_;
  std::vector<std::thread> workers_;
};

}  // namespace pose_host
