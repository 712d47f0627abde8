// Coordinator: negotiates which named collectives are globally ready.
//
// Native re-implementation of the reference's controller (reference:
// horovod/common/controller.{h,cc}): rank 0 gathers per-cycle request lists,
// counts per-tensor readiness in a message table (controller.cc:943-966),
// validates cross-rank consistency (controller.cc:472-749), fuses ready
// tensors into batches under the fusion threshold with same-dtype grouping
// (controller.cc:778-915), handles Join (controller.cc:254-307) and
// broadcasts the agreed ResponseList.  A signature LRU cache plays the
// response cache's role (reference: response_cache.h:44-100) and a stall
// tracker the stall inspector's (stall_inspector.h:31-82).
//
// Why it exists on TPU: the XLA/SPMD path needs no negotiation (programs are
// deterministic), but eager frontends (torch-style define-by-run) submit
// collectives in nondeterministic order per process; this controller gives
// all processes one agreed execution order, which is what prevents
// cross-process deadlock (SURVEY.md §2.4).
//
// Cache fast path (reference: response_cache.h:44-100 + CoordinateCacheAndState
// controller.cc:751-776): every rank keeps an IDENTICAL cache replica of
// previously negotiated tensors, updated only from broadcast data so replicas
// never diverge.  A steady-state cycle ships fixed-size hit/invalidate
// bit-vectors instead of full request lists; agreed hits are reconstructed
// locally from the replica and fused, collapsing per-cycle coordination
// bytes to ~2*ceil(slots/8) once a workload repeats.
//
// Plan-epoch fast path (the layer ABOVE the bit-vector cache): rank 0
// fingerprints each *burst* of agreed-hit cycles (bursts are delimited by
// idle cycles, so a burst is one steady step's worth of cached responses).
// When the fingerprint repeats for HOROVOD_BYPASS_STABLE_CYCLES consecutive
// bursts, rank 0 rides an epoch-lock flag on the boundary broadcast; every
// rank (applying identical broadcast data) then freezes the burst's fused
// response sequence as the *locked plan* and serves subsequent steps by
// replaying it locally — ZERO transport round trips per step.  The lock
// breaks symmetrically on any deviation: a new/changed tensor, a JOIN, a
// shutdown request, a partial replay round outliving its timeout (the
// missing-tensor case), or a remote break observed through Transport::Peek
// (a peer resumed the lock-step wire).  Breaking falls back to full
// negotiation (partial-round submissions re-materialize through carry_),
// and the replica cache underneath is untouched — relocking needs only K
// fresh stable bursts.  An elastic reset destroys the core, and the epoch
// with it.

#pragma once

#include <atomic>
#include <chrono>
#include <cstdint>
#include <list>
#include <mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "common.h"
#include "trace.h"
#include "transport.h"

namespace hvdtpu {

struct ControllerOptions {
  int64_t fusion_threshold_bytes = 128LL * 1024 * 1024;
  int cache_capacity = 1024;
  double stall_warn_seconds = 60.0;
  // Plan-epoch negotiation bypass (env HOROVOD_BYPASS /
  // HOROVOD_BYPASS_STABLE_CYCLES override these at construction; the
  // knobs are validated Python-side at hvd.init, common/knobs.py).
  bool bypass_enabled = true;
  int bypass_stable_cycles = 5;
  // A locked-epoch replay round left partial for this long means a
  // tensor of the locked set went missing (or a rank wedged): break the
  // epoch so the full path's cross-rank stall machinery takes over.
  double bypass_partial_round_break_seconds = 1.0;
};

// Fixed-bucket latency histogram: bucket b counts observations with
// value <= 2^b µs; the last bucket absorbs overflow.  Fixed layout (no
// allocation) so the C API exports it as a flat block and the Python
// registry's power-of-2-µs bounds map onto it 1:1
// (horovod_tpu/utils/metrics.py BUCKET_BOUNDS).
struct LatencyHistogram {
  static constexpr int kBuckets = 28;  // 1 µs .. ~134 s
  uint64_t buckets[kBuckets] = {0};
  uint64_t count = 0;
  uint64_t sum_us = 0;
  void Observe(uint64_t us) {
    count++;
    sum_us += us;
    int b = 0;
    while (b < kBuckets - 1 && us > (1ull << b)) b++;
    buckets[b]++;
  }
};

struct ControllerStats {
  uint64_t cycles = 0;
  uint64_t cache_hits = 0;       // requests served via the bit-vector path
  uint64_t cache_misses = 0;     // requests that took the full gather path
  uint64_t stall_warnings = 0;
  uint64_t responses = 0;
  uint64_t cached_responses = 0; // responses reconstructed from the replica
  uint64_t bytes_gathered = 0;   // this rank's outbound gather frame bytes
  uint64_t bytes_broadcast = 0;  // broadcast frame bytes seen by this rank
  uint64_t last_cycle_bytes = 0; // gather+bcast bytes of the last cycle
  // --- metrics-plane extensions (exported via hvd_core_metrics) ---
  uint64_t bytes_reduced = 0;       // payload bytes of OK reduce-class resp.
  uint64_t tensors_negotiated = 0;  // tensors across OK responses
  uint64_t fused_batches = 0;       // OK response batches executed
  uint64_t fused_batch_bytes = 0;   // payload bytes across those batches
  // --- plan-epoch fast path (docs/tensor-fusion.md#steady-state) ---
  uint64_t bypass_cycles = 0;       // replay rounds served w/o transport
  uint64_t epoch_locks = 0;         // epoch-lock broadcasts applied
  uint64_t epoch_invalidations = 0; // epoch breaks (any cause)
  LatencyHistogram cycle_time_us;       // RunCycle wall time, every rank
  LatencyHistogram negotiation_age_us;  // first-seen -> ready, rank 0 only
};

// Atomic mirror of LatencyHistogram: the cycle loop observes while the
// Python metrics thread (hvd_core_metrics) and the flight recorder
// snapshot concurrently.  Relaxed ordering everywhere — these are
// monotone statistics, not synchronization; a snapshot that splits an
// Observe across count/sum/bucket is off by one observation, which is
// exactly the tolerance the plain-struct version silently assumed while
// being a data race (TSan finding, docs/static-analysis.md).
struct AtomicLatencyHistogram {
  std::atomic<uint64_t> buckets[LatencyHistogram::kBuckets] = {};
  std::atomic<uint64_t> count{0};
  std::atomic<uint64_t> sum_us{0};
  void Observe(uint64_t us) {
    count.fetch_add(1, std::memory_order_relaxed);
    sum_us.fetch_add(us, std::memory_order_relaxed);
    int b = 0;
    while (b < LatencyHistogram::kBuckets - 1 && us > (1ull << b)) b++;
    buckets[b].fetch_add(1, std::memory_order_relaxed);
  }
  LatencyHistogram Snapshot() const {
    LatencyHistogram h;
    h.count = count.load(std::memory_order_relaxed);
    h.sum_us = sum_us.load(std::memory_order_relaxed);
    for (int i = 0; i < LatencyHistogram::kBuckets; i++)
      h.buckets[i] = buckets[i].load(std::memory_order_relaxed);
    return h;
  }
};

// Atomic mirror of ControllerStats (same fields, same meanings): the
// counters are written by the cycle-loop thread AND — on the locked-
// epoch fast path — by submitter threads under bypass_mu_, while
// hvd_core_metrics/hvd_core_stats snapshot them from the Python metrics
// thread and the flight recorder reads them from a fatal-signal
// handler.  Lock-free atomics serve all four: writers stay wait-free on
// the hot path and the crash-time reader can never block behind a
// wedged lock (atomic loads are async-signal-safe).  Snapshot() renders
// the plain POD every external consumer keeps seeing.
struct AtomicControllerStats {
  std::atomic<uint64_t> cycles{0};
  std::atomic<uint64_t> cache_hits{0};
  std::atomic<uint64_t> cache_misses{0};
  std::atomic<uint64_t> stall_warnings{0};
  std::atomic<uint64_t> responses{0};
  std::atomic<uint64_t> cached_responses{0};
  std::atomic<uint64_t> bytes_gathered{0};
  std::atomic<uint64_t> bytes_broadcast{0};
  std::atomic<uint64_t> last_cycle_bytes{0};
  std::atomic<uint64_t> bytes_reduced{0};
  std::atomic<uint64_t> tensors_negotiated{0};
  std::atomic<uint64_t> fused_batches{0};
  std::atomic<uint64_t> fused_batch_bytes{0};
  std::atomic<uint64_t> bypass_cycles{0};
  std::atomic<uint64_t> epoch_locks{0};
  std::atomic<uint64_t> epoch_invalidations{0};
  AtomicLatencyHistogram cycle_time_us;
  AtomicLatencyHistogram negotiation_age_us;
  ControllerStats Snapshot() const {
    ControllerStats s;
    s.cycles = cycles.load(std::memory_order_relaxed);
    s.cache_hits = cache_hits.load(std::memory_order_relaxed);
    s.cache_misses = cache_misses.load(std::memory_order_relaxed);
    s.stall_warnings = stall_warnings.load(std::memory_order_relaxed);
    s.responses = responses.load(std::memory_order_relaxed);
    s.cached_responses = cached_responses.load(std::memory_order_relaxed);
    s.bytes_gathered = bytes_gathered.load(std::memory_order_relaxed);
    s.bytes_broadcast = bytes_broadcast.load(std::memory_order_relaxed);
    s.last_cycle_bytes = last_cycle_bytes.load(std::memory_order_relaxed);
    s.bytes_reduced = bytes_reduced.load(std::memory_order_relaxed);
    s.tensors_negotiated =
        tensors_negotiated.load(std::memory_order_relaxed);
    s.fused_batches = fused_batches.load(std::memory_order_relaxed);
    s.fused_batch_bytes =
        fused_batch_bytes.load(std::memory_order_relaxed);
    s.bypass_cycles = bypass_cycles.load(std::memory_order_relaxed);
    s.epoch_locks = epoch_locks.load(std::memory_order_relaxed);
    s.epoch_invalidations =
        epoch_invalidations.load(std::memory_order_relaxed);
    s.cycle_time_us = cycle_time_us.Snapshot();
    s.negotiation_age_us = negotiation_age_us.Snapshot();
    return s;
  }
};

class Controller {
 public:
  Controller(Transport* transport, const ControllerOptions& opts);

  // One lock-step cycle: contribute `pending` local requests, receive the
  // globally agreed response list (identical on every rank).
  // shutdown_requested: this rank wants out; when all ranks do, a SHUTDOWN
  // response is emitted.  Returns false on transport failure.
  bool RunCycle(const std::vector<Request>& pending, bool shutdown_requested,
                std::vector<Response>* out);

  // --- plan-epoch fast path -------------------------------------------
  // Locked-epoch verdict for one submission (thread-safe: callable from
  // the submitter's thread, which is how responses are built inline at
  // submit time).  kServed consumed the request into the current replay
  // round and appended any plan batches it completed to `out`; kBreak
  // broke the epoch (partial-round requests re-materialized via carry_)
  // and the caller must route the request through the full path.
  enum class BypassResult { kNotLocked, kServed, kBreak };
  BypassResult TryBypassSubmit(const Request& req,
                               std::vector<Response>* out);
  // True (and the epoch broken) when the current replay round has been
  // partial longer than bypass_partial_round_break_seconds — the
  // missing-tensor / wedged-peer escape hatch.
  bool BypassRoundTimedOut();
  // Unconditional epoch break (shutdown, remote Peek, JOIN).  No-op when
  // not locked.
  void BreakEpoch(const char* reason);
  bool epoch_locked() const {
    return epoch_locked_.load(std::memory_order_acquire);
  }

  // Point-in-time copy built from relaxed atomic loads: safe against the
  // cycle loop, the bypass submit path, and even a fatal-signal handler
  // (postmortem.cc reads it crash-time).
  ControllerStats stats() const { return stats_.Snapshot(); }
  int rank() const { return transport_->rank(); }
  int size() const { return transport_->size(); }

  // Autotune hook: only rank 0 fuses, so retuning the threshold here is
  // globally consistent (reference: rank-0 tunes then broadcasts,
  // controller.cc:39-53 SynchronizeParameters).  Atomic: written by the
  // cycle loop's autotune update, read by hvd_core_metrics from the
  // Python metrics thread (TSan finding, docs/static-analysis.md).
  void set_fusion_threshold(int64_t v) {
    fusion_threshold_.store(v, std::memory_order_relaxed);
  }
  int64_t fusion_threshold() const {
    return fusion_threshold_.load(std::memory_order_relaxed);
  }

  // Tracing-plane hook (trace.h): cycle-phase spans land here when set.
  void set_trace(TraceRing* t) { trace_ = t; }

  // Memory plane (hvd_core_mem): approximate heap bytes held by the
  // replicated response cache — slot structs plus the name/sig strings
  // they own.  replica_ is cycle-thread-owned (mutated only inside
  // RunCycle's broadcast apply), so this MUST only be called from the
  // cycle loop (Core::StampWindow), which publishes the value through
  // an atomic for lock-free readers.
  int64_t ApproxCacheBytes() const {
    int64_t b = static_cast<int64_t>(replica_.capacity() * sizeof(CacheSlot));
    for (const CacheSlot& s : replica_)
      b += static_cast<int64_t>(s.name.size() + s.sig.size());
    return b;
  }

 private:
  // --- rank-0 state ---
  struct Entry {
    std::vector<Request> requests;       // one per contributing rank
    std::chrono::steady_clock::time_point first_seen;
    bool warned = false;
  };
  void Ingest(const Request& req, int rank);
  std::vector<Response> BuildResponses();
  void CheckStalls();

  // --- replicated cache (identical on every rank) ---
  struct CacheSlot {
    std::string name;
    std::string sig;
    RequestType op = RequestType::ALLREDUCE;
    int64_t bytes = 0;
    bool valid = false;
  };
  // Allocate/overwrite a slot for a negotiated tensor; replica-deterministic
  // (called only with broadcast data, in broadcast order).
  void ReplicaInsert(const std::string& name, const std::string& sig,
                     RequestType op, int64_t bytes);
  void ReplicaErase(int slot);

  Transport* transport_;
  ControllerOptions opts_;
  std::atomic<int64_t> fusion_threshold_{0};
  AtomicControllerStats stats_;
  TraceRing* trace_ = nullptr;

  std::unordered_map<std::string, Entry> table_;
  std::vector<std::string> arrival_order_;
  std::vector<bool> joined_;     // per-rank JOIN flags
  int last_joined_ = -1;         // rank whose JOIN completed the set
  std::vector<bool> shutdown_;   // per-rank shutdown flags

  std::vector<CacheSlot> replica_;
  std::unordered_map<std::string, int> slot_of_;
  std::list<std::pair<int, std::string>> fifo_;  // (slot, name) insert order
  std::vector<char> local_hits_;     // this rank's pending cache-hit bits
  std::vector<char> local_inv_;      // invalidations this rank wants
  // Requests re-materialized for the full path (invalidation, capacity
  // eviction, epoch break).  Guarded by bypass_mu_: BreakEpochLocked
  // refills it from a SUBMITTER's thread while the cycle loop consumes
  // it at the top of RunCycle (TSan finding, docs/static-analysis.md).
  std::vector<Request> carry_;
  // rank-0: per-slot first-partial-hit time for stall detection (0 = none)
  std::vector<std::chrono::steady_clock::time_point> partial_since_;
  std::vector<char> partial_warned_;

  // --- plan-epoch state (guarded by bypass_mu_; epoch_locked_ is also
  // an atomic so hot paths can check it without the lock).  The
  // replicated accumulation (burst_plan_) is driven purely by broadcast
  // content, so every rank freezes an identical locked plan; the rank-0
  // stability counter (r0_*) is driven by the same pre-broadcast values
  // that get serialized, so its lock flag is consistent by construction.
  void BreakEpochLocked(const char* reason);  // bypass_mu_ held
  mutable std::mutex bypass_mu_;
  std::atomic<bool> epoch_locked_{false};
  uint64_t epoch_ = 0;
  std::vector<Response> locked_plan_;           // one round, emission order
  std::unordered_map<std::string, int> plan_batch_of_;   // name -> batch
  std::unordered_map<std::string, std::pair<std::string, RequestType>>
      locked_set_;                               // name -> (sig, op)
  std::vector<int> round_missing_;               // per batch, names awaited
  size_t round_emitted_ = 0;                     // batches emitted in order
  std::vector<Request> round_received_;          // for carry_ on break
  std::unordered_set<std::string> round_names_;
  std::chrono::steady_clock::time_point round_started_;
  bool kick_pending_ = false;                    // rank 0: Kick before next cycle
  // replicated burst accumulation (all ranks, apply phase)
  std::vector<Response> burst_plan_;
  bool burst_valid_ = true;
  // rank-0 burst fingerprint + stability counter (pre-broadcast phase)
  std::string r0_burst_sig_;
  std::string r0_last_sig_;
  bool r0_burst_valid_ = true;
  int r0_stable_ = 0;
};

}  // namespace hvdtpu
