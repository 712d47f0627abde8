// Flight recorder: crash-time forensics for the native core.
//
// The reference answers "how is the run doing" (timeline, stall
// inspector) but nothing answers "why did the run die" — a fatal signal
// in the controller/transport layer leaves a bare exit status.  This
// module is the third observability leg (after metrics and tracing): it
// keeps the core's TraceRing recording as a rolling
// black box and, when the process dies abnormally, writes a versioned
// flight-record file containing the span tail, a metrics snapshot,
// tensor-queue/transport state and the last-progress cycle stamp —
// everything `hvdrun doctor` needs to attribute the crash
// (horovod_tpu/postmortem.py parses it; docs/postmortem.md).
//
// Triggers:
//   * fatal signals (SIGSEGV/SIGABRT/SIGBUS/SIGFPE/SIGILL) + std::terminate
//     once FlightRecorderArm was called (hvd_core_flight_enable);
//   * an explicit hvd_core_flight_dump(path) call at any time.
//
// The signal path is ASYNC-SIGNAL-SAFE by construction: open/write/close
// only, hand-rolled integer formatting, no allocation, no locks beyond
// the ring's bounded try-lock (trace.h SnapshotTail).  After the dump the
// original signal disposition is restored and the signal re-raised, so
// the process still dies with the status supervisors expect.

#pragma once

namespace hvdtpu {

class Core;

// Arm the process-global recorder for `core`: install the fatal-signal +
// terminate handlers (once per process) and remember `path` as the dump
// target.  Also enables the core's trace ring — a flight recorder that
// only starts recording at the crash has nothing to say.  One core per
// process is armed; re-arming replaces the previous registration.
void FlightRecorderArm(Core* core, const char* path);

// Forget `core` if it is the armed one.  Must run before the core is
// destroyed: a signal arriving afterwards must find nullptr, not a
// dangling pointer.
void FlightRecorderDisarm(Core* core);

// Explicit dump (hvd_core_flight_dump): same record format, reason
// "explicit:<reason>".  Returns 0 on success, -1 when the file cannot
// be opened.
int FlightDump(Core* core, const char* path, const char* reason);

// Shared writer for both paths; exposed for tests.
void WriteFlightRecord(Core* core, int fd, const char* reason);

}  // namespace hvdtpu
