// Background cycle loop + submission/response queues.
//
// The reference runs one background thread per process that wakes every
// cycle_time ms, negotiates, then executes fused collectives (reference:
// operations.cc:589-647 RunLoopOnce, spawned at operations.cc:690-691).
// Here the thread owns negotiation only — execution happens in the frontend
// (XLA) in the agreed order — so the loop is: drain submit queue, RunCycle,
// publish responses, wait for the next submission OR the cycle-time tick
// (a condition variable, not a fixed sleep: a lone sync op wakes the loop
// in microseconds, and idle ticks keep housekeeping/stall checks alive).
// In the locked-epoch state (controller.h plan epochs) submissions are
// served inline at submit time from the cached plan — the loop only ticks
// to watch for epoch breaks (partial-round timeout, transport Peek).

#pragma once

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <utility>
#include <vector>

#include "common.h"
#include "controller.h"
#include "optim.h"
#include "trace.h"
#include "transport.h"
#include "window.h"

namespace hvdtpu {

// Timed condition-variable wait.  Under SAN=tsan builds (HVD_TSAN_BUILD,
// csrc/Makefile) the wait is routed through wait_until on the SYSTEM
// clock: libstdc++'s wait_for waits on the steady clock via
// pthread_cond_clockwait, which gcc-10's libtsan does not intercept —
// TSan then loses the mutex's lock accounting across the wait and
// floods the run with phantom "double lock" / "data race" reports
// (minimal repro + rationale in docs/static-analysis.md).  The system
// clock maps to the intercepted pthread_cond_timedwait.  Production
// builds keep the steady-clock wait_for: a system clock step must not
// stretch a cycle tick.
template <class Rep, class Period, class Pred>
bool CvWaitFor(std::condition_variable* cv,
               std::unique_lock<std::mutex>* lk,
               std::chrono::duration<Rep, Period> d, Pred pred) {
#ifdef HVD_TSAN_BUILD
  return cv->wait_until(
      *lk,
      std::chrono::system_clock::now() +
          std::chrono::duration_cast<std::chrono::microseconds>(d),
      pred);
#else
  return cv->wait_for(*lk, d, pred);
#endif
}

struct CoreOptions {
  double cycle_time_ms = 1.0;
  ControllerOptions controller;
};

class Core {
 public:
  Core(std::unique_ptr<Transport> transport, const CoreOptions& opts);
  ~Core();

  // Returns 0 on success, -1 duplicate in-flight name, -2 after shutdown.
  // (duplicate rejection: reference DUPLICATE_NAME_ERROR, tensor_queue.cc)
  int Submit(const Request& req);
  // Non-blocking; returns true when a response was popped.
  bool Poll(Response* out);
  // Blocks until a response arrives or timeout; false on timeout/shutdown.
  bool Wait(Response* out, double timeout_s);

  void Shutdown();          // begin coordinated shutdown
  bool healthy() const { return healthy_.load(); }
  int rank() const { return controller_->rank(); }
  int size() const { return controller_->size(); }
  ControllerStats stats() const;
  TransportStats transport_stats() const {
    return transport_->transport_stats();
  }
  int64_t fusion_threshold() const { return controller_->fusion_threshold(); }

  // Liveness snapshot for the postmortem plane (hvd_core_health +
  // flight records, csrc/postmortem.cc).  Built from atomics and plain
  // reads only — NO locks — so it is safe from a fatal-signal handler
  // and can never block a healthy caller behind a wedged cycle loop
  // (the one situation where you most want to read it).
  struct HealthSnapshot {
    uint64_t now_us = 0;               // ring steady clock at snapshot
    uint64_t cycles = 0;               // controller cycles completed
    uint64_t last_progress_age_us = 0; // ring µs since the last cycle
    int64_t queue_depth = 0;           // submitted, not yet responded
    int64_t responses_pending = 0;     // responded, not yet consumed
    bool transport_healthy = false;
    bool shutdown = false;
  };
  HealthSnapshot health_snapshot() const;

  // Memory plane (hvd_core_mem, docs/memory.md): the native core's own
  // footprint.  RSS and the response-cache bytes are stamped by the
  // cycle loop (StampWindow, kMinPeriodUs cadence) into atomics, the
  // ring sizes are construction-time constants — so the snapshot is
  // lock-free and safe beside a wedged cycle loop, like HealthSnapshot.
  struct MemSnapshot {
    uint64_t rss_bytes = 0;            // process resident set (statm)
    uint64_t peak_rss_bytes = 0;       // getrusage ru_maxrss
    uint64_t trace_ring_bytes = 0;     // TraceRing capacity * event size
    uint64_t window_ring_bytes = 0;    // MetricsWindowRing footprint
    uint64_t response_cache_bytes = 0; // replicated cache heap (approx)
    uint64_t stamps = 0;               // cycle-loop refreshes so far
  };
  MemSnapshot mem_snapshot() const;

  // Perf-attribution plane (docs/profiling.md): per-op-name
  // enqueue->done aggregates, keyed by the collapsed tensor name so the
  // controller path's cycle cost attributes to the ops that caused it.
  // Exported through the versioned hvd_core_op_stats C API.
  struct OpStat {
    uint64_t count = 0;
    uint64_t bytes = 0;
    uint64_t sum_us = 0;
    uint64_t max_us = 0;
  };
  // Cardinality bound: beyond this many distinct names new ops
  // aggregate under "__other__" (names are collapsed like the timeline's
  // collapse_name, so steady-state workloads stay far below it).
  static constexpr size_t kMaxOpStatNames = 256;
  std::vector<std::pair<std::string, OpStat>> op_stats() const;

  // Tracing plane (trace.h): the ring is always allocated but disabled
  // (one relaxed atomic load per would-be event); EnableTrace flips it
  // on and hvd_core_trace drains it (csrc/c_api.cc).
  void EnableTrace() { trace_.Enable(); }
  TraceRing* trace() { return &trace_; }

  // Watch plane (window.h): per-second rates over the trailing window,
  // differentiated natively against the cycle loop's epoch-stamped
  // snapshot ring.  Exported through the versioned
  // hvd_core_metrics_window C API (csrc/c_api.cc; docs/watch.md).
  struct WindowRates {
    uint64_t span_us = 0;      // history actually covered (<= asked)
    double cycle_rate = 0.0;   // controller cycles per second
    double bytes_rate = 0.0;   // reduced payload bytes per second
    double reconnect_rate = 0.0;   // transport reconnects per MINUTE
    double bypass_fraction = 0.0;  // bypass rounds / all rounds, [0, 1]
  };
  WindowRates metrics_window(double window_s) const;

  // Turn on rank-0 autotuning of (fusion threshold, cycle time) scored by
  // negotiated bytes/sec (reference: ParameterManager + HOROVOD_AUTOTUNE,
  // parameter_manager.{h,cc}).  Rank 0 fuses and paces the lock-step
  // gather, so tuning it alone retunes the whole job.
  void EnableAutotune(const ParameterManager::Options& opts);
  // Snapshot of the live tunables: (threshold, cycle_ms, done, best_score).
  bool AutotuneState(int64_t* threshold, double* cycle_ms, int* done,
                     double* best_score) const;

 private:
  void Loop();
  // Hand a cycle's (or a bypass round's) responses to consumers: op-stat
  // aggregation, inflight clearing, queue push + wakeup.  mu_ held.
  void PublishResponsesLocked(std::vector<Response>* out,
                              bool* got_shutdown, int64_t* cycle_bytes);

  // Stamp one window sample when due (cycle loop, every iteration —
  // DuePush gates the cost to one spinlock round trip per tick).
  void StampWindow();

  std::unique_ptr<Transport> transport_;
  std::unique_ptr<Controller> controller_;
  CoreOptions opts_;
  TraceRing trace_;
  mutable MetricsWindowRing window_;

  mutable std::mutex mu_;
  std::condition_variable cv_;
  // Event-driven cycle pacing: Submit/Shutdown signal this so a lone
  // sync op pays microseconds, not a cycle-time tick (the tick remains
  // as the wait timeout — idle housekeeping, stall checks and epoch
  // timeouts still run on the cycle cadence).
  std::condition_variable submit_cv_;
  std::unique_ptr<ParameterManager> pm_;  // guarded by mu_
  std::vector<Request> pending_;
  std::unordered_set<std::string> inflight_;
  std::queue<Response> responses_;
  // perf plane (guarded by mu_): submit timestamps by raw name, plus
  // the per-collapsed-name aggregates op_stats() snapshots.
  std::unordered_map<std::string, uint64_t> submit_us_;
  std::unordered_map<std::string, OpStat> op_stats_;

  std::atomic<bool> shutdown_requested_{false};
  std::atomic<bool> stopped_{false};
  std::atomic<bool> healthy_{true};
  // Postmortem-plane counters (health_snapshot): maintained as atomics
  // beside the mu_-guarded structures they shadow, because the crash
  // path must read them lock-free.
  std::atomic<uint64_t> last_progress_us_{0};
  std::atomic<int64_t> inflight_count_{0};
  std::atomic<int64_t> responses_pending_{0};
  // Memory-plane atomics (mem_snapshot): refreshed by the cycle loop in
  // StampWindow, read lock-free from hvd_core_mem on any thread.
  std::atomic<uint64_t> mem_rss_bytes_{0};
  std::atomic<uint64_t> mem_peak_rss_bytes_{0};
  std::atomic<uint64_t> mem_cache_bytes_{0};
  std::atomic<uint64_t> mem_stamps_{0};
  std::thread thread_;
};

}  // namespace hvdtpu
