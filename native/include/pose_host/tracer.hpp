// Header-only RAII scope tracer: cumulative wall time + call counts per
// scope, hierarchical report (rebuild of the reference's
// src/tracer.h TRACE_SCOPE facility [MED; empty reference mount —
// SURVEY.md §5]; written from scratch).
#pragma once

#include <chrono>
#include <map>
#include <mutex>
#include <sstream>
#include <string>

namespace pose_host {

class Tracer {
 public:
  static Tracer& instance() {
    static Tracer t;
    return t;
  }

  void record(const std::string& name, double seconds) {
    std::lock_guard<std::mutex> lk(mu_);
    auto& e = entries_[name];
    e.total_s += seconds;
    e.calls += 1;
  }

  std::string report() const {
    std::lock_guard<std::mutex> lk(mu_);
    std::ostringstream os;
    os << "scope                               calls     total s    mean ms\n";
    for (const auto& [name, e] : entries_) {
      char buf[160];
      std::snprintf(buf, sizeof(buf), "%-36s%6ld%12.3f%11.3f\n", name.c_str(),
                    e.calls, e.total_s,
                    e.calls ? e.total_s / e.calls * 1e3 : 0.0);
      os << buf;
    }
    return os.str();
  }

  void reset() {
    std::lock_guard<std::mutex> lk(mu_);
    entries_.clear();
  }

 private:
  struct Entry {
    double total_s = 0;
    long calls = 0;
  };
  mutable std::mutex mu_;
  std::map<std::string, Entry> entries_;
};

class TraceScope {
 public:
  explicit TraceScope(std::string name)
      : name_(std::move(name)), t0_(std::chrono::steady_clock::now()) {}
  ~TraceScope() {
    auto dt = std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                            t0_).count();
    Tracer::instance().record(name_, dt);
  }

 private:
  std::string name_;
  std::chrono::steady_clock::time_point t0_;
};

#define PH_TRACE_SCOPE(name) ::pose_host::TraceScope _ph_trace_scope_(name)

}  // namespace pose_host
