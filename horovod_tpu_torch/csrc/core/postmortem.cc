#include "postmortem.h"

#include <fcntl.h>
#include <signal.h>
#include <unistd.h>

#include <atomic>
#include <cstring>
#include <exception>

#include "core.h"

namespace hvdtpu {
namespace {

std::atomic<Core*> g_core{nullptr};
char g_path[1024] = {0};
std::atomic<bool> g_installed{false};
std::atomic<bool> g_dumping{false};
std::terminate_handler g_prev_terminate = nullptr;

// ---------------------------------------------------- signal-safe output
// write(2) + hand-rolled formatting only: snprintf/localtime/malloc are
// all off-limits inside a fatal-signal handler.

void PutStr(int fd, const char* s) {
  size_t n = strlen(s);
  while (n > 0) {
    ssize_t w = ::write(fd, s, n);
    if (w <= 0) return;  // crash-time best effort: never loop on error
    s += w;
    n -= static_cast<size_t>(w);
  }
}

void PutChar(int fd, char c) {
  char buf[2] = {c, '\0'};
  PutStr(fd, buf);
}

void PutU64(int fd, uint64_t v) {
  char buf[24];
  char* p = buf + sizeof(buf) - 1;
  *p = '\0';
  do {
    *--p = static_cast<char>('0' + v % 10);
    v /= 10;
  } while (v != 0);
  PutStr(fd, p);
}

void PutI64(int fd, int64_t v) {
  if (v < 0) {
    PutChar(fd, '-');
    PutU64(fd, static_cast<uint64_t>(-(v + 1)) + 1);
  } else {
    PutU64(fd, static_cast<uint64_t>(v));
  }
}

void PutKV(int fd, const char* key, uint64_t v) {
  PutStr(fd, key);
  PutChar(fd, ' ');
  PutU64(fd, v);
  PutChar(fd, '\n');
}

const char* SigName(int sig) {
  switch (sig) {
    case SIGSEGV: return "SIGSEGV";
    case SIGABRT: return "SIGABRT";
    case SIGBUS: return "SIGBUS";
    case SIGFPE: return "SIGFPE";
    case SIGILL: return "SIGILL";
    default: return "SIG?";
  }
}

void DumpNow(const char* reason) {
  Core* core = g_core.load(std::memory_order_acquire);
  if (core == nullptr || g_path[0] == '\0') return;
  int fd = ::open(g_path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return;
  WriteFlightRecord(core, fd, reason);
  ::close(fd);
}

void FatalSignalHandler(int sig) {
  // One dump per process: a second fault inside the dump (or a second
  // signal racing it) must fall straight through to the default death.
  if (!g_dumping.exchange(true)) {
    char reason[32];
    strcpy(reason, "signal:");          // local buffers only: safe
    strcat(reason, SigName(sig));
    DumpNow(reason);
  }
  ::signal(sig, SIG_DFL);
  ::raise(sig);  // die with the original status supervisors expect
}

void TerminateHandler() {
  if (!g_dumping.exchange(true)) DumpNow("terminate");
  if (g_prev_terminate != nullptr) g_prev_terminate();
  ::abort();
}

void InstallHandlers() {
  if (g_installed.exchange(true)) return;
  struct sigaction sa;
  memset(&sa, 0, sizeof(sa));
  sa.sa_handler = FatalSignalHandler;
  sigemptyset(&sa.sa_mask);
  const int kFatal[] = {SIGSEGV, SIGABRT, SIGBUS, SIGFPE, SIGILL};
  for (int sig : kFatal) sigaction(sig, &sa, nullptr);
  g_prev_terminate = std::set_terminate(TerminateHandler);
}

}  // namespace

void WriteFlightRecord(Core* core, int fd, const char* reason) {
  // Versioned line-oriented record (horovod_tpu/postmortem.py parses):
  //   hvd_flight_v1
  //   reason <reason>            header: name-keyed lines
  //   ...
  //   [health] / [metrics] / [trace]   sections
  //   [end]                      present <=> the write completed
  // New keys/sections APPEND; parsers key on names and ignore unknowns —
  // the same versioning contract as hvd_core_metrics.
  TraceRing* ring = core->trace();
  PutStr(fd, "hvd_flight_v1\n");
  PutStr(fd, "reason ");
  PutStr(fd, reason != nullptr && reason[0] ? reason : "?");
  PutChar(fd, '\n');
  PutKV(fd, "rank", static_cast<uint64_t>(core->rank()));
  PutKV(fd, "size", static_cast<uint64_t>(core->size()));
  PutKV(fd, "now_us", ring->NowUs());

  Core::HealthSnapshot h = core->health_snapshot();
  PutStr(fd, "[health]\n");
  PutKV(fd, "cycles", h.cycles);
  PutKV(fd, "last_progress_age_us", h.last_progress_age_us);
  PutStr(fd, "queue_depth ");
  PutI64(fd, h.queue_depth);
  PutChar(fd, '\n');
  PutStr(fd, "responses_pending ");
  PutI64(fd, h.responses_pending);
  PutChar(fd, '\n');
  PutKV(fd, "transport_healthy", h.transport_healthy ? 1 : 0);
  PutKV(fd, "shutdown", h.shutdown ? 1 : 0);

  // Relaxed atomic snapshots (Atomic{Controller,Transport}Stats): loads
  // only, so they are async-signal-safe and never block behind a lock
  // the interrupted thread holds.  A counter landing mid-increment is
  // off by one — an acceptable price at crash time.
  ControllerStats s = core->stats();
  TransportStats ts = core->transport_stats();
  PutStr(fd, "[metrics]\n");
  PutKV(fd, "cycles", s.cycles);
  PutKV(fd, "responses", s.responses);
  PutKV(fd, "cached_responses", s.cached_responses);
  PutKV(fd, "cache_hits", s.cache_hits);
  PutKV(fd, "cache_misses", s.cache_misses);
  PutKV(fd, "stall_warnings", s.stall_warnings);
  PutKV(fd, "bytes_gathered", s.bytes_gathered);
  PutKV(fd, "bytes_broadcast", s.bytes_broadcast);
  PutKV(fd, "bytes_reduced", s.bytes_reduced);
  PutKV(fd, "tensors_negotiated", s.tensors_negotiated);
  PutKV(fd, "transport_reconnects", ts.reconnects);
  PutKV(fd, "transport_reconnect_failures", ts.reconnect_failures);
  PutKV(fd, "transport_frames_resent", ts.frames_resent);
  PutKV(fd, "transport_frames_dropped", ts.frames_dropped);
  PutKV(fd, "chaos_faults_injected", ts.chaos_faults);

  // Span tail: static buffer, not stack — the handler may be running on
  // the remnants of an overflowed stack.  g_dumping serializes access.
  PutStr(fd, "[trace]\n");
  static TraceRing::Event evs[256];
  uint64_t dropped = 0;
  size_t n = ring->SnapshotTail(evs, 256, &dropped);
  PutKV(fd, "trace_dropped", dropped);
  for (size_t i = 0; i < n; i++) {
    const TraceRing::Event& e = evs[i];
    PutU64(fd, e.ts_us);
    PutChar(fd, ' ');
    PutChar(fd, e.phase);
    PutChar(fd, ' ');
    PutChar(fd, e.cat);
    PutChar(fd, ' ');
    PutStr(fd, e.name[0] ? e.name : "?");
    PutChar(fd, ' ');
    PutI64(fd, e.arg);
    PutChar(fd, '\n');
  }
  PutStr(fd, "[end]\n");
}

void FlightRecorderArm(Core* core, const char* path) {
  if (path != nullptr && path[0]) {
    strncpy(g_path, path, sizeof(g_path) - 1);
    g_path[sizeof(g_path) - 1] = '\0';
  }
  // A flight recorder that starts recording at the crash has nothing to
  // say: arming turns the ring on for the rest of the process lifetime
  // (overwrite-oldest bounds the cost; nobody needs to drain it).
  core->EnableTrace();
  g_core.store(core, std::memory_order_release);
  InstallHandlers();
}

void FlightRecorderDisarm(Core* core) {
  Core* expected = core;
  g_core.compare_exchange_strong(expected, nullptr);
}

int FlightDump(Core* core, const char* path, const char* reason) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  char buf[256];
  strcpy(buf, "explicit:");
  strncat(buf, reason != nullptr ? reason : "", sizeof(buf) - 10);
  WriteFlightRecord(core, fd, buf);
  ::close(fd);
  return 0;
}

}  // namespace hvdtpu
