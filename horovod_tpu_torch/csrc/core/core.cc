#include "core.h"

#include <sys/resource.h>
#include <unistd.h>

#include <chrono>
#include <cstdio>

namespace hvdtpu {

namespace {

// Current resident set in bytes from /proc/self/statm (field 2 is
// resident pages).  Returns 0 where procfs is unavailable — the memory
// plane reports what it can measure, never guesses.
uint64_t ReadRssBytes() {
  FILE* f = std::fopen("/proc/self/statm", "r");
  if (!f) return 0;
  unsigned long long size = 0, resident = 0;
  int got = std::fscanf(f, "%llu %llu", &size, &resident);
  std::fclose(f);
  if (got != 2) return 0;
  long page = sysconf(_SC_PAGESIZE);
  return resident * static_cast<uint64_t>(page > 0 ? page : 4096);
}

// Lifetime peak RSS in bytes.  ru_maxrss is KB on Linux, bytes on
// Darwin (the only two platforms this builds on).
uint64_t ReadPeakRssBytes() {
  struct rusage ru;
  if (getrusage(RUSAGE_SELF, &ru) != 0) return 0;
#ifdef __APPLE__
  return static_cast<uint64_t>(ru.ru_maxrss);
#else
  return static_cast<uint64_t>(ru.ru_maxrss) * 1024ull;
#endif
}

// Collapse auto-generated per-call names to their prefix — the same rule
// as the timeline's collapse_name (utils/timeline.py): unbounded
// per-call names would otherwise exhaust the op-stats cardinality bound
// in one epoch.
std::string CollapseOpName(const std::string& name) {
  for (const char* marker : {".noname.", ".tfneg."}) {
    auto pos = name.find(marker);
    if (pos != std::string::npos) return name.substr(0, pos);
  }
  return name;
}

}  // namespace

Core::Core(std::unique_ptr<Transport> transport, const CoreOptions& opts)
    : transport_(std::move(transport)), opts_(opts) {
  controller_.reset(new Controller(transport_.get(), opts.controller));
  // Tracing plane: one ring per core; controller cycle phases and
  // transport frame/reconnect/chaos events share it (disabled until
  // hvd_core_trace_enable).  Transport bring-up (constructor) predates
  // this wiring, so initial-connect events are not captured — only
  // steady-state operation and recovery are.
  controller_->set_trace(&trace_);
  transport_->set_trace(&trace_);
  thread_ = std::thread(&Core::Loop, this);
}

Core::~Core() {
  Shutdown();
  if (thread_.joinable()) thread_.join();
}

int Core::Submit(const Request& req) {
  std::lock_guard<std::mutex> lk(mu_);
  if (stopped_.load()) return -2;
  if (req.type != RequestType::JOIN && inflight_.count(req.name))
    return -1;  // reference: DUPLICATE_NAME_ERROR (tensor_queue.cc)
  inflight_.insert(req.name);
  // Perf plane: enqueue stamp for the op-stats enqueue->done latency
  // (hvd_core_op_stats).  JOIN excluded — it is a barrier, not an op.
  if (req.type != RequestType::JOIN)
    submit_us_[req.name] = trace_.NowUs();
  // Locked-epoch fast path: a steady-set submission is served right
  // here, on the submitter's thread, from the cached plan — zero
  // transport, zero thread handoff.  A deviation breaks the epoch
  // inside TryBypassSubmit and falls through to the negotiated queue.
  if (req.type != RequestType::JOIN && controller_->epoch_locked()) {
    std::vector<Response> out;
    auto v = controller_->TryBypassSubmit(req, &out);
    if (v == Controller::BypassResult::kServed) {
      if (!out.empty()) {
        bool got_shutdown = false;
        int64_t bytes = 0;
        PublishResponsesLocked(&out, &got_shutdown, &bytes);
      }
      inflight_count_.store(static_cast<int64_t>(inflight_.size()),
                            std::memory_order_relaxed);
      return 0;
    }
  }
  pending_.push_back(req);
  inflight_count_.store(static_cast<int64_t>(inflight_.size()),
                        std::memory_order_relaxed);
  submit_cv_.notify_one();
  return 0;
}

std::vector<std::pair<std::string, Core::OpStat>> Core::op_stats() const {
  std::lock_guard<std::mutex> lk(mu_);
  return std::vector<std::pair<std::string, OpStat>>(op_stats_.begin(),
                                                     op_stats_.end());
}

bool Core::Poll(Response* out) {
  std::lock_guard<std::mutex> lk(mu_);
  if (responses_.empty()) return false;
  *out = responses_.front();
  responses_.pop();
  responses_pending_.store(static_cast<int64_t>(responses_.size()),
                           std::memory_order_relaxed);
  return true;
}

bool Core::Wait(Response* out, double timeout_s) {
  std::unique_lock<std::mutex> lk(mu_);
  bool got = CvWaitFor(
      &cv_, &lk, std::chrono::duration<double>(timeout_s),
      [&] { return !responses_.empty() || stopped_.load(); });
  if (!got || responses_.empty()) return false;
  *out = responses_.front();
  responses_.pop();
  responses_pending_.store(static_cast<int64_t>(responses_.size()),
                           std::memory_order_relaxed);
  return true;
}

void Core::Shutdown() {
  shutdown_requested_.store(true);
  std::lock_guard<std::mutex> lk(mu_);
  submit_cv_.notify_all();
}

ControllerStats Core::stats() const { return controller_->stats(); }

void Core::StampWindow() {
  uint64_t now = trace_.NowUs();
  if (!window_.DuePush(now)) return;
  WindowSample s;
  s.ts_us = now;
  ControllerStats cs = controller_->stats();
  TransportStats ts = transport_->transport_stats();
  s.cycles = cs.cycles;
  s.bypass_cycles = cs.bypass_cycles;
  s.responses = cs.responses;
  s.bytes_reduced = cs.bytes_reduced;
  s.transport_reconnects = ts.reconnects;
  window_.Push(s);
  // Memory plane: refresh the mem atomics on the same DuePush cadence.
  // This runs on the cycle thread, the one place ApproxCacheBytes may
  // be called (replica_ is cycle-thread-owned); readers see the values
  // lock-free through mem_snapshot().
  mem_rss_bytes_.store(ReadRssBytes(), std::memory_order_relaxed);
  mem_peak_rss_bytes_.store(ReadPeakRssBytes(), std::memory_order_relaxed);
  mem_cache_bytes_.store(
      static_cast<uint64_t>(controller_->ApproxCacheBytes()),
      std::memory_order_relaxed);
  mem_stamps_.fetch_add(1, std::memory_order_relaxed);
}

Core::MemSnapshot Core::mem_snapshot() const {
  MemSnapshot m;
  m.rss_bytes = mem_rss_bytes_.load(std::memory_order_relaxed);
  m.peak_rss_bytes = mem_peak_rss_bytes_.load(std::memory_order_relaxed);
  m.trace_ring_bytes = trace_.CapacityBytes();
  m.window_ring_bytes = sizeof(MetricsWindowRing);
  m.response_cache_bytes = mem_cache_bytes_.load(std::memory_order_relaxed);
  m.stamps = mem_stamps_.load(std::memory_order_relaxed);
  // Before the first cycle-loop stamp the atomics are empty; answer
  // with a direct (still signal-safe) read so an early caller never
  // sees a zero RSS on a live process.
  if (m.stamps == 0) {
    m.rss_bytes = ReadRssBytes();
    m.peak_rss_bytes = ReadPeakRssBytes();
  }
  return m;
}

Core::WindowRates Core::metrics_window(double window_s) const {
  WindowRates out;
  uint64_t now = trace_.NowUs();
  uint64_t window_us = window_s > 0
      ? static_cast<uint64_t>(window_s * 1e6) : 60000000ull;
  WindowSample ref;
  if (!window_.Reference(now, window_us, &ref) || now <= ref.ts_us)
    return out;  // no history yet: every rate honestly zero
  ControllerStats cs = controller_->stats();
  TransportStats ts = transport_->transport_stats();
  out.span_us = now - ref.ts_us;
  double span_s = out.span_us / 1e6;
  auto delta = [](uint64_t a, uint64_t b) {
    return a > b ? static_cast<double>(a - b) : 0.0;
  };
  double d_cycles = delta(cs.cycles, ref.cycles);
  double d_bypass = delta(cs.bypass_cycles, ref.bypass_cycles);
  out.cycle_rate = d_cycles / span_s;
  out.bytes_rate = delta(cs.bytes_reduced, ref.bytes_reduced) / span_s;
  out.reconnect_rate =
      delta(ts.reconnects, ref.transport_reconnects) / span_s * 60.0;
  // Steady-state fraction: replay rounds served from the locked plan
  // over all rounds (bypass + full cycles) of the window.
  if (d_cycles + d_bypass > 0)
    out.bypass_fraction = d_bypass / (d_cycles + d_bypass);
  return out;
}

Core::HealthSnapshot Core::health_snapshot() const {
  HealthSnapshot h;
  h.now_us = trace_.NowUs();
  // Relaxed atomic snapshot (AtomicControllerStats): lock-free, so this
  // stays safe from a fatal-signal handler and can never block behind a
  // wedged cycle loop.
  h.cycles = controller_->stats().cycles;
  uint64_t lp = last_progress_us_.load(std::memory_order_relaxed);
  h.last_progress_age_us = h.now_us > lp ? h.now_us - lp : 0;
  h.queue_depth = inflight_count_.load(std::memory_order_relaxed);
  h.responses_pending = responses_pending_.load(std::memory_order_relaxed);
  h.transport_healthy = healthy_.load(std::memory_order_relaxed);
  h.shutdown = stopped_.load(std::memory_order_relaxed);
  return h;
}

void Core::EnableAutotune(const ParameterManager::Options& opts) {
  std::lock_guard<std::mutex> lk(mu_);
  if (controller_->rank() != 0) return;  // rank 0 fuses + paces the job
  pm_.reset(new ParameterManager(controller_->fusion_threshold(),
                                 opts_.cycle_time_ms, opts));
}

bool Core::AutotuneState(int64_t* threshold, double* cycle_ms, int* done,
                         double* best_score) const {
  std::lock_guard<std::mutex> lk(mu_);
  if (!pm_) return false;
  *threshold = pm_->threshold();
  *cycle_ms = pm_->cycle_time_ms();
  *done = pm_->done() ? 1 : 0;
  *best_score = pm_->best_score();
  return true;
}

// mu_ held by the caller.
void Core::PublishResponsesLocked(std::vector<Response>* out,
                                  bool* got_shutdown,
                                  int64_t* cycle_bytes) {
  for (auto& r : *out) {
    if (r.type == ResponseType::SHUTDOWN) {
      *got_shutdown = true;
      continue;
    }
    if (r.type == ResponseType::OK) *cycle_bytes += r.total_bytes;
    // Perf plane: fold each named op's enqueue->done latency and
    // payload bytes into the per-collapsed-name aggregates
    // (hvd_core_op_stats) before the response is handed off.
    uint64_t done_us = trace_.NowUs();
    for (size_t i = 0; i < r.names.size(); i++) {
      const std::string& n = r.names[i];
      inflight_.erase(n);
      auto it = submit_us_.find(n);
      if (it == submit_us_.end()) continue;
      uint64_t age = done_us > it->second ? done_us - it->second : 0;
      submit_us_.erase(it);
      std::string key = CollapseOpName(n);
      if (op_stats_.size() >= kMaxOpStatNames && !op_stats_.count(key))
        key = "__other__";
      OpStat& s = op_stats_[key];
      s.count++;
      s.sum_us += age;
      if (age > s.max_us) s.max_us = age;
      if (i < r.sizes.size() && r.sizes[i] > 0)
        s.bytes += static_cast<uint64_t>(r.sizes[i]);
    }
    responses_.push(std::move(r));
  }
  inflight_count_.store(static_cast<int64_t>(inflight_.size()),
                        std::memory_order_relaxed);
  responses_pending_.store(static_cast<int64_t>(responses_.size()),
                           std::memory_order_relaxed);
  if (!out->empty()) cv_.notify_all();
  out->clear();
}

void Core::Loop() {
  using clock = std::chrono::steady_clock;
  while (!stopped_.load()) {
    auto start = clock::now();
    // Watch plane: stamp the window ring every due period, idle and
    // locked-epoch iterations included (the `continue` below skips the
    // cycle tail, so the stamp lives at the top) — a quiet core's rates
    // decay to zero instead of freezing at the last busy value.
    StampWindow();
    std::vector<Request> batch;
    {
      std::lock_guard<std::mutex> lk(mu_);
      batch.swap(pending_);
    }
    // Locked-epoch state: the inline-submit path serves steady traffic,
    // so the loop only (a) routes queue remnants through the bypass
    // (requests that raced a lock transition), (b) watches for epoch
    // breaks — a shutdown request, a partial replay round outliving its
    // timeout (missing tensor), or a peer resuming the lock-step wire
    // (transport Peek) — and (c) keeps the liveness stamp fresh.  When
    // the epoch breaks, fall through into full negotiation.
    if (controller_->epoch_locked()) {
      if (shutdown_requested_.load()) {
        controller_->BreakEpoch("shutdown");
      } else {
        std::vector<Request> fall;
        {
          // Serve + publish under mu_, like the inline-submit path: an
          // interleaved inline serve must not publish a later plan
          // batch ahead of this one (responses_ order IS the agreed
          // execution order).
          std::lock_guard<std::mutex> lk(mu_);
          std::vector<Response> out;
          for (auto& req : batch) {
            if (controller_->TryBypassSubmit(req, &out) !=
                Controller::BypassResult::kServed)
              fall.push_back(std::move(req));
          }
          bool got_shutdown = false;
          int64_t bytes = 0;
          PublishResponsesLocked(&out, &got_shutdown, &bytes);
        }
        batch = std::move(fall);
        if (controller_->epoch_locked() && batch.empty()) {
          if (transport_->Peek()) {
            controller_->BreakEpoch("remote");
          } else if (!controller_->BypassRoundTimedOut()) {
            last_progress_us_.store(trace_.NowUs(),
                                    std::memory_order_relaxed);
            std::unique_lock<std::mutex> lk(mu_);
            CvWaitFor(
                &submit_cv_, &lk,
                std::chrono::duration<double, std::milli>(
                    opts_.cycle_time_ms),
                [&] {
                  return !pending_.empty() || stopped_.load() ||
                         shutdown_requested_.load();
                });
            continue;
          }
        }
      }
    }
    std::vector<Response> out;
    if (!controller_->RunCycle(batch, shutdown_requested_.load(), &out)) {
      // transport failure: a peer died mid-negotiation.  Surface as an
      // ERROR response so the frontend raises HorovodInternalError
      // (reference: SHUT_DOWN error surfacing, elastic.py:151-175).
      healthy_.store(false);
      Response r;
      r.type = ResponseType::ERROR_;
      r.error_message = "controller transport failure (peer died?)";
      std::lock_guard<std::mutex> lk(mu_);
      responses_.push(r);
      stopped_.store(true);
      cv_.notify_all();
      return;
    }
    bool got_shutdown = false;
    int64_t cycle_bytes = 0;
    {
      std::lock_guard<std::mutex> lk(mu_);
      PublishResponsesLocked(&out, &got_shutdown, &cycle_bytes);
    }
    // Postmortem plane: a completed cycle IS the liveness heartbeat of
    // this core — health_snapshot ages against this stamp.
    last_progress_us_.store(trace_.NowUs(), std::memory_order_relaxed);
    if (got_shutdown) {
      stopped_.store(true);
      cv_.notify_all();
      return;
    }
    // Event-driven cycle tail (was: a fixed sleep_for): wait out the
    // remainder of the cycle OR wake the instant a submission lands, so
    // a lone sync op pays a fraction of a tick instead of a full one.
    // The timeout keeps the idle cadence — lock-step peers expect a
    // frame per cycle, and stall/autotune housekeeping rides it.  An
    // early wake is followed by a short accumulation nap (cycle/5):
    // the cycle time stays the fusion batching window for bursts —
    // autograd-hook submissions land microseconds apart, so the burst
    // fuses — without re-imposing the full tick on a lone op.
    auto elapsed = clock::now() - start;
    auto cycle = std::chrono::duration<double, std::milli>(
        opts_.cycle_time_ms);
    if (elapsed < cycle) {
      bool woke_early;
      {
        std::unique_lock<std::mutex> lk(mu_);
        woke_early = CvWaitFor(&submit_cv_, &lk, cycle - elapsed, [&] {
          return !pending_.empty() || stopped_.load() ||
                 shutdown_requested_.load();
        });
      }
      if (woke_early && !stopped_.load() && !shutdown_requested_.load())
        std::this_thread::sleep_for(cycle / 5);
    }
    // Autotune on total cycle wall time (reference scores bytes/sec over
    // the sampled cycles, parameter_manager.cc Update).
    {
      std::lock_guard<std::mutex> lk(mu_);
      // Only cycles that processed tensors advance the tuner: idle 1ms
      // cycles would otherwise burn all samples on zero-score points
      // (reference ParameterManager advances per processed tensor batch).
      if (pm_ && !pm_->done() && cycle_bytes > 0) {
        double secs = std::chrono::duration<double>(
            clock::now() - start).count();
        if (pm_->Update(cycle_bytes, secs)) {
          controller_->set_fusion_threshold(pm_->threshold());
          opts_.cycle_time_ms = pm_->cycle_time_ms();
        }
      }
    }
  }
}

}  // namespace hvdtpu
