// extern "C" surface, loaded from Python via ctypes (the analog of the
// reference's extern "C" init/rank/enqueue API, operations.cc:710-915,
// consumed by horovod/common/basics.py).

#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>

#include "core.h"
#include "postmortem.h"

using namespace hvdtpu;

namespace {
// The C handle wraps the core plus a stash for responses that did not fit
// the caller's buffer: a popped response must never be lost to truncation.
struct ApiHandle {
  explicit ApiHandle(Core* c) : core(c) {}
  Core* core;
  std::mutex mu;
  bool has_stash = false;
  Response stash;
};

CoreOptions MakeOptions(double cycle_ms, long fusion_bytes, int cache_cap,
                        double stall_warn_s) {
  CoreOptions o;
  o.cycle_time_ms = cycle_ms;
  o.controller.fusion_threshold_bytes = fusion_bytes;
  o.controller.cache_capacity = cache_cap;
  o.controller.stall_warn_seconds = stall_warn_s;
  return o;
}

// Deliver a response through the caller buffer.  If it fits, consume and
// return its length; otherwise stash it and return -(needed+1) so the
// caller can retry with a larger buffer.
int Deliver(ApiHandle* h, const Response& r, char* buf, int buflen) {
  std::string s;
  {
    static const char* kTypes[] = {"OK", "ERROR", "JOIN_DONE", "SHUTDOWN"};
    s = kTypes[static_cast<int>(r.type)];
    s += "|";
    s += std::to_string(static_cast<int>(r.op));
    s += "|";
    s += std::to_string(r.total_bytes);
    s += "|";
    std::string err = r.error_message;
    for (auto& c : err)
      if (c == '|' || c == '\n') c = ';';  // keep the frame parseable
    s += err;
    s += "|";
    for (size_t i = 0; i < r.names.size(); i++) {
      if (i) s += ",";
      s += r.names[i];
    }
    s += "|";
    for (size_t i = 0; i < r.sigs.size(); i++) {
      if (i) s += ",";
      s += r.sigs[i];
    }
  }
  int n = static_cast<int>(s.size());
  if (!buf || buflen <= n) {
    std::lock_guard<std::mutex> lk(h->mu);
    h->has_stash = true;
    h->stash = r;
    return -(n + 1);
  }
  memcpy(buf, s.data(), n);
  buf[n] = '\0';
  {
    std::lock_guard<std::mutex> lk(h->mu);
    h->has_stash = false;
  }
  return n;
}

bool TakeStash(ApiHandle* h, Response* out) {
  std::lock_guard<std::mutex> lk(h->mu);
  if (!h->has_stash) return false;
  *out = h->stash;
  return true;
}

}  // namespace

extern "C" {

// Build identity of the loaded library: name-keyed "k=v" pairs,
// space-separated; new pairs APPEND and parsers key on names (the
// hvd_core_metrics versioning contract).  `sanitizer` is stamped by the
// Makefile's SAN mode so a TSan/ASan/UBSan build can never silently
// masquerade as the production library — the Python loader logs it,
// hvd.metrics_snapshot() exports it, and bench artifact runs refuse it
// (docs/static-analysis.md).
#ifndef HVD_SANITIZER
#define HVD_SANITIZER "none"
#endif
const char* hvd_native_build_info(void) {
  return "sanitizer=" HVD_SANITIZER;
}

void* hvd_loopback_hub_create(int size) { return new LoopbackHub(size); }
void hvd_loopback_hub_destroy(void* hub) {
  delete static_cast<LoopbackHub*>(hub);
}

void* hvd_core_create_loopback(void* hub, int rank, double cycle_ms,
                               long fusion_bytes, int cache_cap,
                               double stall_warn_s) {
  auto t = std::unique_ptr<Transport>(
      new LoopbackTransport(static_cast<LoopbackHub*>(hub), rank));
  return new ApiHandle(new Core(std::move(t),
                                MakeOptions(cycle_ms, fusion_bytes,
                                            cache_cap, stall_warn_s)));
}

void* hvd_core_create_tcp(int rank, int size, const char* addr, int port,
                          int timeout_ms, double cycle_ms, long fusion_bytes,
                          int cache_cap, double stall_warn_s) {
  auto t = std::unique_ptr<TcpTransport>(
      new TcpTransport(rank, size, addr ? addr : "127.0.0.1", port,
                       timeout_ms));
  if (!t->ok()) {
    return nullptr;
  }
  return new ApiHandle(new Core(
      std::unique_ptr<Transport>(std::move(t)),
      MakeOptions(cycle_ms, fusion_bytes, cache_cap, stall_warn_s)));
}

void hvd_core_destroy(void* h) {
  ApiHandle* ah = static_cast<ApiHandle*>(h);
  // A fatal signal after this point must find no registration, not a
  // dangling pointer (postmortem.cc flight recorder).
  FlightRecorderDisarm(ah->core);
  delete ah->core;
  delete ah;
}

int hvd_core_rank(void* h) {
  return static_cast<ApiHandle*>(h)->core->rank();
}
int hvd_core_size(void* h) {
  return static_cast<ApiHandle*>(h)->core->size();
}
int hvd_core_healthy(void* h) {
  return static_cast<ApiHandle*>(h)->core->healthy() ? 1 : 0;
}

// op: RequestType; returns 0 ok, -1 duplicate name, -2 shut down,
// -3 reserved delimiter in name/signature.
int hvd_core_submit(void* h, const char* name, const char* signature,
                    int op, long bytes) {
  Core* core = static_cast<ApiHandle*>(h)->core;
  Request r;
  r.rank = core->rank();
  r.type = static_cast<RequestType>(op);
  r.name = name ? name : "";
  r.signature = signature ? signature : "";
  r.bytes = bytes;
  // '|' and ',' frame the C-API response format; reject them in both the
  // name and the signature (both are echoed back in responses).
  if (r.name.find('|') != std::string::npos ||
      r.name.find(',') != std::string::npos ||
      r.signature.find('|') != std::string::npos ||
      r.signature.find(',') != std::string::npos)
    return -3;
  return core->Submit(r);
}

int hvd_core_join(void* h) {
  Core* core = static_cast<ApiHandle*>(h)->core;
  Request r;
  r.rank = core->rank();
  r.type = RequestType::JOIN;
  r.name = "__join__";
  return core->Submit(r);
}

// Non-blocking poll; returns formatted length (0 = none pending,
// negative = -(needed+1): retry with a bigger buffer, response retained).
int hvd_core_poll(void* h, char* buf, int buflen) {
  ApiHandle* ah = static_cast<ApiHandle*>(h);
  Response r;
  if (!TakeStash(ah, &r) && !ah->core->Poll(&r)) return 0;
  return Deliver(ah, r, buf, buflen);
}

// Blocking wait; returns length, 0 on timeout, negative as above.
int hvd_core_wait(void* h, double timeout_s, char* buf, int buflen) {
  ApiHandle* ah = static_cast<ApiHandle*>(h);
  Response r;
  if (!TakeStash(ah, &r) && !ah->core->Wait(&r, timeout_s)) return 0;
  return Deliver(ah, r, buf, buflen);
}

void hvd_core_shutdown(void* h) {
  static_cast<ApiHandle*>(h)->core->Shutdown();
}

// DEPRECATED in favor of hvd_core_metrics (kept for compat): the fixed
// 9-slot layout cannot grow without breaking every caller.
// stats: cycles, cache_hits, cache_misses, stall_warnings, responses,
//        cached_responses, bytes_gathered, bytes_broadcast, last_cycle_bytes
void hvd_core_stats(void* h, unsigned long long* out9) {
  ControllerStats s = static_cast<ApiHandle*>(h)->core->stats();
  out9[0] = s.cycles;
  out9[1] = s.cache_hits;
  out9[2] = s.cache_misses;
  out9[3] = s.stall_warnings;
  out9[4] = s.responses;
  out9[5] = s.cached_responses;
  out9[6] = s.bytes_gathered;
  out9[7] = s.bytes_broadcast;
  out9[8] = s.last_cycle_bytes;
}

// Versioned metrics export superseding hvd_core_stats: writes a
// self-describing text block —
//   hvd_metrics_v1
//   <counter> <value>            (one line per counter)
//   hist <name> <count> <sum_us> <b0> ... <b27>
// New counters/histograms APPEND; parsers must key on names, never on
// line positions — that is the versioning contract.  Returns the full
// length required; when it exceeds buflen-1 only buflen-1 bytes are
// written (always NUL-terminated) and the caller retries with a larger
// buffer.
int hvd_core_metrics(void* h, char* buf, int buflen) {
  Core* core = static_cast<ApiHandle*>(h)->core;
  ControllerStats s = core->stats();
  std::string t = "hvd_metrics_v1\n";
  auto kv = [&t](const char* k, uint64_t v) {
    t += k;
    t += ' ';
    t += std::to_string(v);
    t += '\n';
  };
  kv("cycles", s.cycles);
  kv("cache_hits", s.cache_hits);
  kv("cache_misses", s.cache_misses);
  kv("stall_warnings", s.stall_warnings);
  kv("responses", s.responses);
  kv("cached_responses", s.cached_responses);
  kv("bytes_gathered", s.bytes_gathered);
  kv("bytes_broadcast", s.bytes_broadcast);
  kv("last_cycle_bytes", s.last_cycle_bytes);
  kv("bytes_reduced", s.bytes_reduced);
  kv("tensors_negotiated", s.tensors_negotiated);
  kv("fused_batches", s.fused_batches);
  kv("fused_batch_bytes", s.fused_batch_bytes);
  kv("fusion_threshold_bytes",
     static_cast<uint64_t>(core->fusion_threshold()));
  // plan-epoch fast path (docs/tensor-fusion.md#steady-state): appended
  // per the name-keyed versioning contract above.
  kv("bypass_cycles", s.bypass_cycles);
  kv("epoch_locks", s.epoch_locks);
  kv("epoch_invalidations", s.epoch_invalidations);
  // transport resilience / chaos-plane counters (docs/chaos.md): appended
  // per the name-keyed versioning contract above.
  TransportStats ts = core->transport_stats();
  kv("transport_reconnects", ts.reconnects);
  kv("transport_reconnect_failures", ts.reconnect_failures);
  kv("transport_frames_resent", ts.frames_resent);
  kv("transport_frames_dropped", ts.frames_dropped);
  kv("transport_frames_coalesced", ts.frames_coalesced);
  kv("transport_coalesced_bytes", ts.coalesced_bytes);
  kv("chaos_faults_injected", ts.chaos_faults);
  auto hist = [&t](const char* name, const LatencyHistogram& hg) {
    t += "hist ";
    t += name;
    t += ' ';
    t += std::to_string(hg.count);
    t += ' ';
    t += std::to_string(hg.sum_us);
    for (int i = 0; i < LatencyHistogram::kBuckets; i++) {
      t += ' ';
      t += std::to_string(hg.buckets[i]);
    }
    t += '\n';
  };
  hist("cycle_time_us", s.cycle_time_us);
  hist("negotiation_age_us", s.negotiation_age_us);
  int n = static_cast<int>(t.size());
  if (buf && buflen > 0) {
    int copy = n < buflen - 1 ? n : buflen - 1;
    memcpy(buf, t.data(), copy);
    buf[copy] = '\0';
  }
  return n;
}

// ------------------------------------------------------------ window rates
// Watch plane (docs/watch.md): trailing-window rates differentiated
// natively against the cycle loop's epoch-stamped snapshot ring
// (csrc/window.h) — a versioned text block in the hvd_core_metrics mold:
//   hvd_metrics_window_v1
//   span_us <n>             (history covered; 0 = no samples yet)
//   cycle_rate <v>          (controller cycles per second)
//   bytes_reduced_rate <v>  (reduced payload bytes per second)
//   reconnect_rate <v>      (transport reconnects per minute)
//   bypass_fraction <v>     (bypass replay rounds / all rounds, 0..1)
// New lines APPEND; parsers key on names — the versioning contract.
// Truncation semantics match hvd_core_metrics (full length returned,
// at most buflen-1 bytes written, always NUL-terminated).
int hvd_core_metrics_window(void* h, double window_s, char* buf,
                            int buflen) {
  Core::WindowRates r =
      static_cast<ApiHandle*>(h)->core->metrics_window(window_s);
  std::string t = "hvd_metrics_window_v1\n";
  t += "span_us ";
  t += std::to_string(r.span_us);
  t += '\n';
  char num[64];
  auto kv = [&t, &num](const char* k, double v) {
    snprintf(num, sizeof(num), "%.9g", v);
    t += k;
    t += ' ';
    t += num;
    t += '\n';
  };
  kv("cycle_rate", r.cycle_rate);
  kv("bytes_reduced_rate", r.bytes_rate);
  kv("reconnect_rate", r.reconnect_rate);
  kv("bypass_fraction", r.bypass_fraction);
  int n = static_cast<int>(t.size());
  if (buf && buflen > 0) {
    int copy = n < buflen - 1 ? n : buflen - 1;
    memcpy(buf, t.data(), copy);
    buf[copy] = '\0';
  }
  return n;
}

// ----------------------------------------------------------------- op stats
// Perf-attribution plane (docs/profiling.md): per-op-name enqueue->done
// aggregates, a versioned text block in the hvd_core_metrics mold —
//   hvd_op_stats_v1
//   <name> <count> <bytes> <sum_us> <max_us>   (one line per name)
// Names are collapsed (CollapseOpName) and whitespace-sanitized so the
// line stays field-splittable; new fields APPEND and parsers key on
// position 1-5 ignoring extras — the versioning contract.  Truncation
// semantics match hvd_core_metrics: returns the full length required,
// writes at most buflen-1 bytes, always NUL-terminated.
int hvd_core_op_stats(void* h, char* buf, int buflen) {
  Core* core = static_cast<ApiHandle*>(h)->core;
  std::string t = "hvd_op_stats_v1\n";
  for (const auto& kv : core->op_stats()) {
    std::string name = kv.first.empty() ? "?" : kv.first;
    for (auto& c : name)
      if (c == ' ' || c == '\t' || c == '\n' || c == '\r') c = '_';
    t += name;
    t += ' ';
    t += std::to_string(kv.second.count);
    t += ' ';
    t += std::to_string(kv.second.bytes);
    t += ' ';
    t += std::to_string(kv.second.sum_us);
    t += ' ';
    t += std::to_string(kv.second.max_us);
    t += '\n';
  }
  int n = static_cast<int>(t.size());
  if (buf && buflen > 0) {
    int copy = n < buflen - 1 ? n : buflen - 1;
    memcpy(buf, t.data(), copy);
    buf[copy] = '\0';
  }
  return n;
}

// ---------------------------------------------------------------- postmortem
// Liveness snapshot (postmortem plane, docs/postmortem.md): a versioned
// text block in the hvd_core_metrics mold —
//   hvd_health_v1
//   <key> <value>               (one line per field)
// New keys APPEND; parsers key on names — the versioning contract.
// Returns the full length required; truncation semantics match
// hvd_core_metrics (always NUL-terminated, caller retries bigger).
int hvd_core_health(void* h, char* buf, int buflen) {
  Core* core = static_cast<ApiHandle*>(h)->core;
  Core::HealthSnapshot hs = core->health_snapshot();
  std::string t = "hvd_health_v1\n";
  auto kv = [&t](const char* k, long long v) {
    t += k;
    t += ' ';
    t += std::to_string(v);
    t += '\n';
  };
  kv("now_us", static_cast<long long>(hs.now_us));
  kv("cycles", static_cast<long long>(hs.cycles));
  kv("last_progress_age_us", static_cast<long long>(hs.last_progress_age_us));
  kv("queue_depth", hs.queue_depth);
  kv("responses_pending", hs.responses_pending);
  kv("transport_healthy", hs.transport_healthy ? 1 : 0);
  kv("shutdown", hs.shutdown ? 1 : 0);
  int n = static_cast<int>(t.size());
  if (buf && buflen > 0) {
    int copy = n < buflen - 1 ? n : buflen - 1;
    memcpy(buf, t.data(), copy);
    buf[copy] = '\0';
  }
  return n;
}

// ------------------------------------------------------------------- memory
// Native-core memory footprint (memory plane, docs/memory.md): a
// versioned text block in the hvd_core_health mold —
//   hvd_mem_v1
//   <key> <value>               (one line per field)
// RSS and the response-cache bytes are stamped by the cycle loop
// (Core::StampWindow) so this read is lock-free; new keys APPEND and
// parsers key on names — the versioning contract.  Returns the full
// length required; truncation semantics match hvd_core_metrics
// (always NUL-terminated, caller retries bigger).
int hvd_core_mem(void* h, char* buf, int buflen) {
  Core* core = static_cast<ApiHandle*>(h)->core;
  Core::MemSnapshot ms = core->mem_snapshot();
  std::string t = "hvd_mem_v1\n";
  auto kv = [&t](const char* k, long long v) {
    t += k;
    t += ' ';
    t += std::to_string(v);
    t += '\n';
  };
  kv("rss_bytes", static_cast<long long>(ms.rss_bytes));
  kv("peak_rss_bytes", static_cast<long long>(ms.peak_rss_bytes));
  kv("trace_ring_bytes", static_cast<long long>(ms.trace_ring_bytes));
  kv("window_ring_bytes", static_cast<long long>(ms.window_ring_bytes));
  kv("response_cache_bytes",
     static_cast<long long>(ms.response_cache_bytes));
  kv("stamps", static_cast<long long>(ms.stamps));
  int n = static_cast<int>(t.size());
  if (buf && buflen > 0) {
    int copy = n < buflen - 1 ? n : buflen - 1;
    memcpy(buf, t.data(), copy);
    buf[copy] = '\0';
  }
  return n;
}

// Arm the crash-time flight recorder: fatal signals / std::terminate
// dump this core's flight record to `path` (postmortem.cc).  Implies
// trace-ring recording so the record's span tail is populated.
void hvd_core_flight_enable(void* h, const char* path) {
  FlightRecorderArm(static_cast<ApiHandle*>(h)->core, path);
}

// Explicit flight dump ("take a black-box snapshot now"): same record
// format, reason "explicit:<reason>".  0 on success, -1 on open failure.
int hvd_core_flight_dump(void* h, const char* path, const char* reason) {
  if (!path || !path[0]) return -1;
  return FlightDump(static_cast<ApiHandle*>(h)->core, path, reason);
}

// ------------------------------------------------------------------- tracing
// Activate the native span ring (trace.h).  Until this is called, Record
// is one relaxed atomic load — tracing costs nothing when off.
void hvd_core_trace_enable(void* h) {
  static_cast<ApiHandle*>(h)->core->EnableTrace();
}

// Versioned trace drain, the span analog of hvd_core_metrics:
//   hvd_trace_v1 <now_us> <dropped>
//   <ts_us> <phase> <cat> <name> <arg>       (one line per event)
// Timestamps are steady-clock µs since ring construction; <now_us> is the
// same clock at drain time, so the caller rebases events onto wall time
// without a shared epoch in the wire format.  Events are CONSUMED as they
// are formatted; when the buffer fills, the remainder stays in the ring
// for the next drain (a drain never truncates an event away).  New fields
// APPEND to the line; parsers key on position 1-5 and ignore extras —
// that is the versioning contract.  Returns bytes written (excluding the
// NUL); 0 means no pending events.
int hvd_core_trace(void* h, char* buf, int buflen) {
  if (!buf || buflen <= 0) return 0;
  TraceRing* ring = static_cast<ApiHandle*>(h)->core->trace();
  std::string t = "hvd_trace_v1 ";
  t += std::to_string(ring->NowUs());
  t += ' ';
  t += std::to_string(ring->dropped());
  t += '\n';
  for (;;) {
    std::vector<TraceRing::Event> evs;
    if (ring->Drain(&evs, 1) == 0) break;
    const TraceRing::Event& e = evs[0];
    std::string line = std::to_string(e.ts_us);
    line += ' ';
    line += e.phase;
    line += ' ';
    line += e.cat;
    line += ' ';
    line += e.name[0] ? e.name : "?";
    line += ' ';
    line += std::to_string(e.arg);
    line += '\n';
    if (static_cast<int>(t.size() + line.size()) >= buflen) {
      // No room: re-record the event with its original timestamp so a
      // small buffer loses nothing.  Stream order is not preserved (the
      // event lands behind newer ones) but timestamps are, and the
      // timeline consumer orders by ts.
      ring->RecordAt(e.ts_us, e.phase, e.cat, e.name, e.arg);
      break;
    }
    t += line;
  }
  int n = static_cast<int>(t.size());
  int copy = n < buflen - 1 ? n : buflen - 1;
  memcpy(buf, t.data(), copy);
  buf[copy] = '\0';
  return copy;
}

// ------------------------------------------------------------------ autotune
namespace {
hvdtpu::ParameterManager::Options MakePMOptions(int warmup_samples,
                                                int steps_per_sample,
                                                int max_samples,
                                                double gp_noise) {
  hvdtpu::ParameterManager::Options o;
  if (warmup_samples >= 0) o.warmup_samples = warmup_samples;
  if (steps_per_sample > 0) o.steps_per_sample = steps_per_sample;
  if (max_samples > 0) o.bayes_opt_max_samples = max_samples;
  if (gp_noise > 0) o.gp_noise = gp_noise;
  return o;
}
}  // namespace

void hvd_core_enable_autotune(void* h, int warmup_samples,
                              int steps_per_sample, int max_samples,
                              double gp_noise) {
  static_cast<ApiHandle*>(h)->core->EnableAutotune(MakePMOptions(
      warmup_samples, steps_per_sample, max_samples, gp_noise));
}

// out4: threshold, cycle_ms, done, best_score.  Returns 0 when autotune is
// not active on this rank.
int hvd_core_autotune_state(void* h, double* out4) {
  int64_t thr;
  double cyc, best;
  int done;
  if (!static_cast<ApiHandle*>(h)->core->AutotuneState(&thr, &cyc, &done,
                                                       &best))
    return 0;
  out4[0] = static_cast<double>(thr);
  out4[1] = cyc;
  out4[2] = done;
  out4[3] = best;
  return 1;
}

// Standalone GP regressor (tests + Python-side tuners).
void* hvd_gp_create(double length, double sigma_f, double noise) {
  return new GaussianProcessRegressor(length, sigma_f, noise);
}
void hvd_gp_destroy(void* h) {
  delete static_cast<GaussianProcessRegressor*>(h);
}
// X: n*d row-major
void hvd_gp_fit(void* h, const double* X, const double* y, int n, int d) {
  std::vector<std::vector<double>> xs(n, std::vector<double>(d));
  for (int i = 0; i < n; i++)
    for (int j = 0; j < d; j++) xs[i][j] = X[i * d + j];
  static_cast<GaussianProcessRegressor*>(h)->Fit(
      xs, std::vector<double>(y, y + n));
}
void hvd_gp_predict(void* h, const double* x, int d, double* mean,
                    double* variance) {
  static_cast<GaussianProcessRegressor*>(h)->Predict(
      std::vector<double>(x, x + d), mean, variance);
}

// Standalone Bayesian optimizer over [0,1]^d.
void* hvd_bo_create(int dims, double xi, unsigned seed, double gp_noise) {
  return new BayesianOptimizer(dims, xi, seed, gp_noise);
}
void hvd_bo_destroy(void* h) { delete static_cast<BayesianOptimizer*>(h); }
void hvd_bo_add_sample(void* h, const double* x, int d, double y) {
  static_cast<BayesianOptimizer*>(h)->AddSample(
      std::vector<double>(x, x + d), y);
}
void hvd_bo_next_sample(void* h, double* out, int d) {
  auto v = static_cast<BayesianOptimizer*>(h)->NextSample();
  for (int i = 0; i < d && i < static_cast<int>(v.size()); i++) out[i] = v[i];
}
double hvd_bo_best_y(void* h) {
  return static_cast<BayesianOptimizer*>(h)->best_y();
}
void hvd_bo_best_x(void* h, double* out, int d) {
  const auto& v = static_cast<BayesianOptimizer*>(h)->best_x();
  for (int i = 0; i < d; i++)
    out[i] = i < static_cast<int>(v.size()) ? v[i] : 0.5;
}

// Standalone parameter manager (Python-side SPMD bucket tuner).
void* hvd_pm_create(long long initial_threshold, double initial_cycle_ms,
                    int warmup_samples, int steps_per_sample,
                    int max_samples, double gp_noise) {
  return new ParameterManager(
      initial_threshold, initial_cycle_ms,
      MakePMOptions(warmup_samples, steps_per_sample, max_samples, gp_noise));
}
void hvd_pm_destroy(void* h) { delete static_cast<ParameterManager*>(h); }
// Returns 1 when tunables changed; out3 = threshold, cycle_ms, done.
int hvd_pm_update(void* h, long long bytes, double seconds, double* out3) {
  ParameterManager* pm = static_cast<ParameterManager*>(h);
  int changed = pm->Update(bytes, seconds) ? 1 : 0;
  out3[0] = static_cast<double>(pm->threshold());
  out3[1] = pm->cycle_time_ms();
  out3[2] = pm->done() ? 1 : 0;
  return changed;
}
double hvd_pm_best_score(void* h) {
  return static_cast<ParameterManager*>(h)->best_score();
}

// Standalone arm bandit (the wire-policy dimension of autotune: arms are
// wire policies, deterministic UCB1, no RNG — see optim.h ArmBandit).
void* hvd_bandit_create(int arms, int steps_per_sample, int max_pulls,
                        double explore) {
  return new ArmBandit(arms, steps_per_sample, max_pulls,
                       explore > 0 ? explore : 0.5);
}
void hvd_bandit_destroy(void* h) { delete static_cast<ArmBandit*>(h); }
// Returns 1 when the active arm changed (or the bandit finalized);
// out3 = arm, done, pulls.
int hvd_bandit_update(void* h, double score, double* out3) {
  ArmBandit* b = static_cast<ArmBandit*>(h);
  int changed = b->Update(score) ? 1 : 0;
  out3[0] = b->arm();
  out3[1] = b->done() ? 1 : 0;
  out3[2] = static_cast<double>(b->pulls());
  return changed;
}
int hvd_bandit_best_arm(void* h) {
  return static_cast<ArmBandit*>(h)->best_arm();
}
double hvd_bandit_best_mean(void* h) {
  return static_cast<ArmBandit*>(h)->best_mean();
}

// Factored two-dimensional bandit (wire policy x overlap depth — the
// overlap plane's autotune dimension, ops/overlap.py; see optim.h
// ProductBandit).  Same determinism contract as hvd_bandit_*.
void* hvd_bandit2_create(int arms_a, int arms_b, int steps_per_sample,
                         int max_pulls, double explore) {
  return new ProductBandit(arms_a, arms_b, steps_per_sample, max_pulls,
                           explore > 0 ? explore : 0.5);
}
void hvd_bandit2_destroy(void* h) { delete static_cast<ProductBandit*>(h); }
// Returns 1 when the active pair changed (or the bandit finalized);
// out4 = arm_a, arm_b, done, pulls.
int hvd_bandit2_update(void* h, double score, double* out4) {
  ProductBandit* b = static_cast<ProductBandit*>(h);
  int changed = b->Update(score) ? 1 : 0;
  out4[0] = b->arm_a();
  out4[1] = b->arm_b();
  out4[2] = b->done() ? 1 : 0;
  out4[3] = static_cast<double>(b->pulls());
  return changed;
}
int hvd_bandit2_best_a(void* h) {
  return static_cast<ProductBandit*>(h)->best_a();
}
int hvd_bandit2_best_b(void* h) {
  return static_cast<ProductBandit*>(h)->best_b();
}

}  // extern "C"
