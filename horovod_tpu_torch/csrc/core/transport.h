// Controller transports: how coordination metadata moves between processes.
//
// The reference runs its coordination protocol over MPI or Gloo (reference:
// mpi_controller.cc gather/bcast at :134-193, gloo_controller.cc:185-264).
// Here the transport is an abstract gather/bcast pair with two built-ins:
//   * LoopbackTransport — all ranks in one process (unit tests, and the
//     single-controller JAX case where negotiation is trivial).
//   * TcpTransport — zero-dependency sockets: rank 0 listens, workers
//     connect; length-prefixed frames.  The gloo-rendezvous analog without
//     the gloo dependency; TPU-VM pods have plain TCP between hosts.
//
// Resilience: the TCP channel frames are sequence-tagged and both sides
// keep the one in-flight frame, so a dropped connection is survivable —
// the worker reconnects with bounded exponential backoff + jitter, a
// resync handshake (hello carries {rank, gathers_sent, bcasts_seen})
// retransmits whatever the break lost, and seq dedup makes every
// retransmission idempotent.  The lock-step cycle protocol (one gather,
// one bcast per cycle) bounds the replay window to a single frame per
// direction.  Fault injection for proving this lives in ChaosInjector,
// gated on HOROVOD_CHAOS_* env knobs (see common/knobs.py, docs/chaos.md).

#pragma once

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <vector>

#include "trace.h"

namespace hvdtpu {

// Fault/retry counters surfaced through hvd_core_metrics (name-keyed
// lines, the versioning contract of that API).
struct TransportStats {
  uint64_t reconnects = 0;           // successful reconnect handshakes
  uint64_t reconnect_failures = 0;   // retry budget exhausted
  uint64_t frames_resent = 0;        // gather/bcast frames retransmitted
  uint64_t frames_dropped = 0;       // chaos-injected frame drops
  uint64_t chaos_faults = 0;         // total injected faults fired
  // Coalesced frame IO (one writev per peer per cycle): frames that
  // shared a vectored write with at least one sibling (resync ack +
  // replay, hello + retransmit), and bytes through the vectored path
  // (every frame — the header/seq/payload assembly copy is gone).
  uint64_t frames_coalesced = 0;
  uint64_t coalesced_bytes = 0;
};

// Atomic mirror of TransportStats: the cycle-loop thread mutates these
// counters while hvd_core_metrics snapshots them from the Python metrics
// thread and the flight recorder reads them from a fatal-signal handler
// — lock-free relaxed atomics serve all three (TSan finding,
// docs/static-analysis.md).  Snapshot() renders the plain POD the
// Transport API keeps returning.
struct AtomicTransportStats {
  std::atomic<uint64_t> reconnects{0};
  std::atomic<uint64_t> reconnect_failures{0};
  std::atomic<uint64_t> frames_resent{0};
  std::atomic<uint64_t> frames_dropped{0};
  std::atomic<uint64_t> chaos_faults{0};
  std::atomic<uint64_t> frames_coalesced{0};
  std::atomic<uint64_t> coalesced_bytes{0};
  TransportStats Snapshot() const {
    TransportStats s;
    s.reconnects = reconnects.load(std::memory_order_relaxed);
    s.reconnect_failures =
        reconnect_failures.load(std::memory_order_relaxed);
    s.frames_resent = frames_resent.load(std::memory_order_relaxed);
    s.frames_dropped = frames_dropped.load(std::memory_order_relaxed);
    s.chaos_faults = chaos_faults.load(std::memory_order_relaxed);
    s.frames_coalesced = frames_coalesced.load(std::memory_order_relaxed);
    s.coalesced_bytes = coalesced_bytes.load(std::memory_order_relaxed);
    return s;
  }
};

// Deterministic seeded fault injector for the TCP transport (the csrc
// half of the chaos plane).  Configured entirely from env so the same
// knobs reach every rank without touching the C API:
//   HOROVOD_CHAOS_SEED            base seed (mixed with the rank)
//   HOROVOD_CHAOS_TCP_RANK        restrict injection to one rank (-1=all)
//   HOROVOD_CHAOS_TCP_CLOSE_AFTER close before the Nth frame op (one-shot)
//   HOROVOD_CHAOS_TCP_CLOSE_RATE  per-op probability of a socket close
//   HOROVOD_CHAOS_TCP_DROP_RATE   per-op probability of frame drop+close
//   HOROVOD_CHAOS_TCP_DUP_RATE    per-op probability of frame duplication
//   HOROVOD_CHAOS_TCP_DELAY_RATE  per-op probability of an injected delay
//   HOROVOD_CHAOS_TCP_DELAY_MS    delay length
class ChaosInjector {
 public:
  enum class Action { kNone, kDelay, kDup, kDrop, kClose };

  explicit ChaosInjector(int rank);
  bool enabled() const { return enabled_; }
  int delay_ms() const { return delay_ms_; }
  // One decision per frame operation; deterministic for a fixed seed.
  Action Next();

 private:
  bool enabled_ = false;
  uint64_t op_index_ = 0;
  long close_after_ = 0;  // 0 = off; counts frame ops on this rank
  double close_rate_ = 0.0, drop_rate_ = 0.0, dup_rate_ = 0.0,
         delay_rate_ = 0.0;
  int delay_ms_ = 0;
  std::mt19937_64 rng_;
};

class Transport {
 public:
  virtual ~Transport() = default;
  virtual int rank() const = 0;
  virtual int size() const = 0;
  // Coordinator (rank 0) receives every rank's frame, index = rank.
  // Workers send theirs.  Returns false on peer failure.
  virtual bool Gather(const std::string& mine,
                      std::vector<std::string>* all) = 0;
  // Coordinator sends one frame to every worker; workers receive it.
  virtual bool Bcast(std::string* frame) = 0;
  // Plan-epoch support (controller.h): while an epoch is locked no rank
  // touches the lock-step wire, so a rank that resumes it must be
  // noticeable without blocking.  Peek is a non-blocking "is a frame
  // pending for me" probe (rank 0: any worker frame; worker: a kick or
  // replay); Kick is rank 0's zero-length advisory frame telling locked
  // workers to rejoin the wire.  Defaults are inert for transports
  // without a wire.
  virtual bool Peek() { return false; }
  virtual void Kick() {}
  // Fault/retry counters; zero for transports without a wire.
  virtual TransportStats transport_stats() const { return TransportStats(); }
  // Tracing-plane hook (trace.h): frame/reconnect/chaos events land in
  // the ring when set; no-op for transports without a wire.
  virtual void set_trace(TraceRing*) {}
};

// All ranks share one object; per-rank handles carry the rank id.
class LoopbackHub {
 public:
  explicit LoopbackHub(int size) : size_(size), gathered_(size) {}

  bool Gather(int rank, const std::string& mine,
              std::vector<std::string>* all);
  // consumed_rounds: per-caller count of bcast rounds already read; lets a
  // late worker recognize an already-posted round (lock-step protocol).
  bool Bcast(int rank, std::string* frame, uint64_t* consumed_rounds);
  // Plan-epoch support: rank 0 peeks for parked worker contributions;
  // workers peek for a kick (consumed per caller via kicks_seen).
  bool Peek(int rank, uint64_t* kicks_seen);
  void Kick();
  // Current kick generation: Bcast consumers sync their kicks_seen to
  // it so a kick outstanding while a worker is ON the wire is absorbed
  // as stale — the exact semantics the TCP transport gets for free by
  // draining empty frames in its Bcast recv loop.  Without this, a
  // round-N break's kick would spuriously break the NEXT locked epoch
  // (found by the race harness, docs/static-analysis.md).
  uint64_t kick_gen();
  int size() const { return size_; }

 private:
  int size_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::vector<std::string> gathered_;
  int gather_count_ = 0;
  uint64_t gather_gen_ = 0;
  std::string bcast_frame_;
  uint64_t bcast_gen_ = 0;
  int bcast_reads_ = 0;
  uint64_t kick_gen_ = 0;
};

class LoopbackTransport : public Transport {
 public:
  LoopbackTransport(LoopbackHub* hub, int rank) : hub_(hub), rank_(rank) {}
  int rank() const override { return rank_; }
  int size() const override { return hub_->size(); }
  bool Gather(const std::string& mine,
              std::vector<std::string>* all) override {
    return hub_->Gather(rank_, mine, all);
  }
  bool Bcast(std::string* frame) override {
    bool ok = hub_->Bcast(rank_, frame, &consumed_rounds_);
    // A consumed bcast proves this rank is on the lock-step wire, so
    // every kick issued up to now is stale (kicks only tell LOCKED
    // workers to rejoin; locking again requires a NEWER bcast's lock
    // flag).  Mirrors TcpTransport::Bcast draining empty kick frames.
    kicks_seen_ = hub_->kick_gen();
    return ok;
  }
  bool Peek() override { return hub_->Peek(rank_, &kicks_seen_); }
  void Kick() override {
    if (rank_ == 0) hub_->Kick();
  }

 private:
  LoopbackHub* hub_;
  int rank_;
  uint64_t consumed_rounds_ = 0;
  uint64_t kicks_seen_ = 0;
};

class TcpTransport : public Transport {
 public:
  // rank 0 binds+listens on port and accepts size-1 workers; others connect
  // to addr:port (retrying until timeout_ms).
  TcpTransport(int rank, int size, const std::string& addr, int port,
               int timeout_ms = 30000);
  ~TcpTransport() override;

  bool ok() const { return ok_; }
  int rank() const override { return rank_; }
  int size() const override { return size_; }
  bool Gather(const std::string& mine,
              std::vector<std::string>* all) override;
  bool Bcast(std::string* frame) override;
  bool Peek() override;
  void Kick() override;
  TransportStats transport_stats() const override {
    return stats_.Snapshot();
  }
  void set_trace(TraceRing* t) override { trace_ = t; }

 private:
  void Trace(char phase, const char* name, int64_t arg = 0,
             char cat = 't') {
    if (trace_ != nullptr && trace_->enabled())
      trace_->Record(phase, cat, name, arg);
  }
  // Coalesced frame IO: n length-prefixed frames in ONE writev — no
  // header+payload assembly copy, one syscall per peer per cycle; n > 1
  // batches the resync ack+replay pairs (stats_.frames_coalesced).
  bool SendFramesV(int fd, const std::string* const* frames, int n);
  bool SendFrame(int fd, const std::string& s);
  bool RecvFrame(int fd, std::string* s);

  // --- resilience machinery (see header comment) ---
  // Chaos hook: one decision per frame op; may shutdown() *fd so the
  // following send/recv fails into the recovery path.  Returns false when
  // the frame should be skipped entirely (injected drop), true otherwise.
  bool MaybeInject(int* fd, bool* dup);
  int ReacceptBudgetMs() const;
  // Worker: (re)establish the rank-0 connection and run the resync
  // handshake; retransmits the pending gather frame when rank 0 lost it.
  bool WorkerHandshake();
  bool WorkerReconnect();
  // Rank 0: accept + resync reconnecting workers until worker r is back.
  bool ReacceptWorker(int r);
  bool ResyncAccepted(int fd, int* got_rank);

  int rank_, size_;
  bool ok_ = false;
  int listen_fd_ = -1;
  int coord_fd_ = -1;                // worker's socket to rank 0
  std::vector<int> worker_fds_;      // rank 0: index = rank (0 unused)

  // retry policy (env: HOROVOD_CONTROLLER_RETRIES / _RETRY_BACKOFF_MS)
  int max_retries_ = 5;
  int backoff_base_ms_ = 50;
  std::mt19937_64 jitter_rng_;

  // worker-side channel state
  uint64_t gathers_sent_ = 0;        // seq of the last gather frame sent
  uint64_t bcasts_seen_ = 0;         // seq of the last bcast frame consumed
  std::string last_gather_frame_;    // seq-tagged, for retransmission
  // rank-0 channel state
  std::vector<uint64_t> gathers_from_;  // per worker: last gather seq seen
  uint64_t bcast_seq_ = 0;
  std::string last_bcast_frame_;     // seq-tagged, for resync replay

  std::string coord_addr_;
  int coord_port_ = 0;

  ChaosInjector chaos_;
  AtomicTransportStats stats_;
  TraceRing* trace_ = nullptr;
};

}  // namespace hvdtpu
