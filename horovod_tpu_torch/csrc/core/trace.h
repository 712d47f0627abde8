// TraceRing: fixed-size lock-light span ring buffer for the native core.
//
// The Python timeline (utils/timeline.py) historically saw only what the
// frontend did; controller cycles, transport reconnects and chaos faults
// happened in this library with no spans at all — the reference's timeline
// has the same blind spot (its writer thread lives frontend-side,
// timeline.{h,cc}).  This ring records BEGIN/END/INSTANT events from the
// cycle loop, the TCP transport, the chaos injector AND the plan-epoch
// fast path (cycle.bypass spans + epoch.lock/epoch.invalidate instants,
// controller.h) — the latter fired from the SUBMITTER's thread, since
// locked-epoch responses are built inline at submit time; the spinlock
// makes recording safe from any thread.  Python drains it through the
// versioned `hvd_core_trace` C API (csrc/c_api.cc) into the timeline
// writer thread, which rebases ring timestamps onto the clock-aligned
// fleet epoch (utils/clocksync.py).
//
// Design constraints:
//   * recording must be cheap on the cycle-loop hot path: one atomic load
//     when disabled (the default), a short spinlock + memcpy when enabled;
//   * fixed capacity, overwrite-oldest: a stalled drainer costs trace
//     completeness (reported via dropped()), never memory or blocking;
//   * timestamps are steady-clock µs since ring construction — the drain
//     header carries "now" in the same clock so the drainer can rebase
//     events onto wall time without a shared epoch in the wire format.

#pragma once

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <vector>

namespace hvdtpu {

class TraceRing {
 public:
  static constexpr int kDefaultCapacity = 8192;
  static constexpr int kNameLen = 24;

  struct Event {
    uint64_t ts_us = 0;   // µs since ring construction (steady clock)
    int64_t arg = 0;      // free-form payload (bytes, counts, ms, ...)
    char phase = 'i';     // 'B' begin, 'E' end, 'i' instant
    char cat = 'c';       // 'c' controller, 't' transport, 'x' chaos
    char name[kNameLen] = {0};
  };

  explicit TraceRing(int capacity = kDefaultCapacity)
      : buf_(capacity > 0 ? capacity : kDefaultCapacity),
        epoch_(std::chrono::steady_clock::now()) {}

  void Enable() { enabled_.store(true, std::memory_order_release); }
  bool enabled() const { return enabled_.load(std::memory_order_acquire); }

  // Ring footprint for the memory plane (hvd_core_mem): the buffer is
  // sized once at construction and never resized, so this is safe to
  // read lock-free from any thread.
  size_t CapacityBytes() const { return buf_.size() * sizeof(Event); }

  uint64_t NowUs() const {
    return static_cast<uint64_t>(
        std::chrono::duration_cast<std::chrono::microseconds>(
            std::chrono::steady_clock::now() - epoch_).count());
  }

  void Record(char phase, char cat, const char* name, int64_t arg = 0) {
    RecordAt(NowUs(), phase, cat, name, arg);
  }

  // Retroactive record: the cycle loop stamps phase boundaries as it goes
  // and commits the spans only for non-idle cycles, so an idle 1 ms loop
  // does not flood the ring.
  void RecordAt(uint64_t ts_us, char phase, char cat, const char* name,
                int64_t arg = 0) {
    if (!enabled()) return;
    Event e;
    e.ts_us = ts_us;
    e.arg = arg;
    e.phase = phase;
    e.cat = cat;
    strncpy(e.name, name ? name : "", kNameLen - 1);
    Lock();
    buf_[head_ % buf_.size()] = e;
    head_++;
    if (head_ - tail_ > buf_.size()) {  // overwrite oldest
      tail_++;
      dropped_++;
    }
    Unlock();
  }

  // Consume up to max_events pending events (oldest first).
  size_t Drain(std::vector<Event>* out, size_t max_events) {
    Lock();
    size_t n = head_ - tail_;
    if (n > max_events) n = max_events;
    for (size_t i = 0; i < n; i++)
      out->push_back(buf_[(tail_ + i) % buf_.size()]);
    tail_ += n;
    Unlock();
    return n;
  }

  uint64_t dropped() {
    Lock();
    uint64_t d = dropped_;
    Unlock();
    return d;
  }

  // Crash-time, non-consuming copy of the newest <= max_events events
  // (flight recorder, csrc/postmortem.cc).  Lock acquisition is a BOUNDED
  // spin: a fatal-signal handler may run while the interrupted thread
  // holds the spinlock, and a handler that spins forever turns a crash
  // into a hang — forensics prefers a possibly-torn read over no dump.
  // Returns the event count; *dropped_out (optional) gets the overwrite
  // counter from the same best-effort read.
  size_t SnapshotTail(Event* out, size_t max_events,
                      uint64_t* dropped_out = nullptr) {
    bool locked = TryLock(100000);
    size_t n = head_ - tail_;
    if (n > buf_.size()) n = buf_.size();
    if (n > max_events) n = max_events;
    size_t start = head_ - n;
    for (size_t i = 0; i < n; i++)
      out[i] = buf_[(start + i) % buf_.size()];
    if (dropped_out) *dropped_out = dropped_;
    if (locked) Unlock();
    return n;
  }

 private:
  void Lock() { while (lock_.test_and_set(std::memory_order_acquire)) {} }
  bool TryLock(int spins) {
    for (int i = 0; i < spins; i++)
      if (!lock_.test_and_set(std::memory_order_acquire)) return true;
    return false;
  }
  void Unlock() { lock_.clear(std::memory_order_release); }

  std::vector<Event> buf_;
  std::chrono::steady_clock::time_point epoch_;
  std::atomic<bool> enabled_{false};
  std::atomic_flag lock_ = ATOMIC_FLAG_INIT;
  size_t head_ = 0;   // next write position (monotonic)
  size_t tail_ = 0;   // next read position (monotonic)
  uint64_t dropped_ = 0;
};

}  // namespace hvdtpu
