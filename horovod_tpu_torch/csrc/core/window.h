// MetricsWindowRing: bounded, lock-light ring of epoch-stamped counter
// snapshots — the native leg of the watch plane (docs/watch.md).
//
// hvd_core_metrics exports only since-start cumulative counters; every
// rate a detector wants (cycles/s, bytes/s, reconnects/min, the bypass
// fraction of the last minute) had to be differentiated by an external
// scraper with its own clock.  This ring keeps that history IN the core:
// the cycle loop stamps one sample of the cumulative counters at most
// every kMinPeriodUs (idle ticks included, so rates decay honestly on a
// quiet core), overwrite-oldest keeps memory fixed at
// kCapacity * sizeof(WindowSample), and `hvd_core_metrics_window`
// (csrc/c_api.cc) differentiates the newest live snapshot against the
// sample nearest the requested window's far edge — rates computed on the
// core's own steady clock, no scraper cadence in the math.
//
// Locking follows TraceRing's discipline (trace.h): a short spinlock
// shared by the single writer (the cycle loop) and readers (the Python
// metrics thread).  Nothing here runs in signal context — the flight
// recorder reads counters, not rates.

#pragma once

#include <atomic>
#include <cstdint>

namespace hvdtpu {

// One epoch-stamped snapshot of the cumulative counters the windowed
// C API differentiates.  New fields APPEND (the struct never crosses
// the C ABI — only the derived rates do).
struct WindowSample {
  uint64_t ts_us = 0;  // ring steady clock (TraceRing::NowUs)
  uint64_t cycles = 0;
  uint64_t bypass_cycles = 0;
  uint64_t responses = 0;
  uint64_t bytes_reduced = 0;
  uint64_t transport_reconnects = 0;
};

class MetricsWindowRing {
 public:
  // 1024 samples x 100 ms floor = >= ~102 s of history at the stamp
  // ceiling — comfortably past the 60 s default query window, at ~48 KB.
  static constexpr int kCapacity = 1024;
  static constexpr uint64_t kMinPeriodUs = 100000;

  // Cheap pre-check so the cycle loop skips building a stats snapshot
  // on the ~99% of 1 ms ticks where no stamp is due.
  bool DuePush(uint64_t now_us) {
    Lock();
    bool due = head_ == tail_ ||
               now_us - buf_[(head_ - 1) % kCapacity].ts_us >= kMinPeriodUs;
    Unlock();
    return due;
  }

  void Push(const WindowSample& s) {
    Lock();
    if (head_ != tail_ &&
        s.ts_us - buf_[(head_ - 1) % kCapacity].ts_us < kMinPeriodUs) {
      Unlock();  // a racing second stamp inside the period: drop it
      return;
    }
    buf_[head_ % kCapacity] = s;
    head_++;
    if (head_ - tail_ > kCapacity) tail_++;  // overwrite oldest
    Unlock();
  }

  // The reference sample the window differentiates against: the newest
  // sample at or before now - window_us, else the oldest retained one
  // (span then covers all available history, never more than asked plus
  // one stamp period).  False when the ring is empty.
  bool Reference(uint64_t now_us, uint64_t window_us,
                 WindowSample* out) {
    Lock();
    if (head_ == tail_) {
      Unlock();
      return false;
    }
    uint64_t edge = now_us > window_us ? now_us - window_us : 0;
    *out = buf_[tail_ % kCapacity];
    for (size_t i = tail_; i != head_; i++) {
      const WindowSample& s = buf_[i % kCapacity];
      if (s.ts_us > edge) break;
      *out = s;
    }
    Unlock();
    return true;
  }

 private:
  void Lock() { while (lock_.test_and_set(std::memory_order_acquire)) {} }
  void Unlock() { lock_.clear(std::memory_order_release); }

  WindowSample buf_[kCapacity];
  std::atomic_flag lock_ = ATOMIC_FLAG_INIT;
  size_t head_ = 0;  // next write position (monotonic)
  size_t tail_ = 0;  // oldest retained position (monotonic)
};

}  // namespace hvdtpu
