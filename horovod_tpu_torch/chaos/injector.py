"""Per-rank chaos injector: executes a :class:`ChaosSpec` deterministically
(the port of ``horovod_tpu/chaos/injector.py``).

One injector per process, installed by the runtime (or explicitly by a
test worker) from the rendezvous-distributed spec.  Every decision comes
from ``random.Random(seed ^ golden_ratio_mix(rank))`` — the same stream
derivation the native transport injector uses (csrc/transport.cc) — so a
run with a fixed seed replays the identical fault schedule on every rank,
which is what turns "elastic survives a kill" from an anecdote into a
repeatable experiment.

One-shot semantics: kill and crash_commit events must not re-fire after
the elastic driver restarts the process (the restart would die at the
same step forever).  When the spec carries a ``state_dir``, fired events
are recorded there as marker files keyed by (event index, rank), which is
exactly the cross-incarnation memory a restarted worker needs; without a
``state_dir`` every incarnation replays the full spec (documented in
docs/chaos.md — fine for stall/blackout, usually wrong for kills).
"""

from __future__ import annotations

import os
import random
import time
from typing import Callable, Optional

from ..common import hvdlogging as log
from .spec import ChaosEvent, ChaosSpec

_GOLDEN = 0x9E3779B97F4A7C15


def rank_stream_seed(seed: int, rank: int) -> int:
    """Independent deterministic stream per rank from one job seed (the
    mix csrc/transport.cc applies to HOROVOD_CHAOS_SEED)."""
    return (seed ^ (_GOLDEN * (rank + 1))) & 0xFFFFFFFFFFFFFFFF


class ChaosInjector:
    """Executes kill/stall/kv_blackout/crash_commit events for one rank."""

    def __init__(self, spec: ChaosSpec, rank: int,
                 exit_fn: Optional[Callable[[int], None]] = None,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.spec = spec
        self.rank = int(rank)
        self.rng = random.Random(rank_stream_seed(spec.seed, self.rank))
        # os._exit, not sys.exit: a chaos kill models SIGKILL/preemption —
        # no atexit handlers, no finally blocks, no state flushes.
        self._exit = exit_fn or os._exit
        self._sleep = sleep_fn
        # Per-EVENT KV fault accounting (event index -> count), so
        # independent blackout windows (e.g. two different shards) ride
        # independently: failures charged to one event never consume
        # another's budget.  _kv_seen counts MATCHING ops per event —
        # the op-offset clock behind mid-run windows (spec.py: for
        # kv_blackout, `step` = ops to observe before failing).
        self._kv_failed: dict = {}
        self._kv_seen: dict = {}
        self._kv_shards: Optional[int] = None  # resolved lazily from knobs

    # ------------------------------------------------------------- one-shot
    def _fired_marker(self, idx: int) -> Optional[str]:
        if not self.spec.state_dir:
            return None
        return os.path.join(self.spec.state_dir,
                            f"chaos_fired_{idx}_rank{self.rank}")

    def _already_fired(self, idx: int) -> bool:
        marker = self._fired_marker(idx)
        return bool(marker) and os.path.exists(marker)

    def _record_fired(self, idx: int) -> None:
        marker = self._fired_marker(idx)
        if not marker:
            return
        os.makedirs(self.spec.state_dir, exist_ok=True)
        with open(marker, "w") as f:
            f.write("fired")

    # -------------------------------------------------------------- events
    def _count(self, kind: str) -> None:
        try:  # telemetry must never take the fault path down
            from ..utils import metrics as M
            M.CHAOS_INJECTIONS.inc(kind=kind)
        except Exception:
            pass

    def _mark(self, name: str, **args) -> None:
        """Named instant on the timeline's chaos lane: an injected fault
        must be VISIBLE in the merged trace on the faulted rank, not just
        counted (docs/timeline.md).  Kill/crash events may not survive to
        the next publish — os._exit is the point — but stalls, blackouts
        and everything before the exit do."""
        from ..utils.timeline import trace_instant
        trace_instant("chaos", name, args=dict(args, rank=self.rank))

    def on_step(self, step: int) -> None:
        """Training-loop hook (``hvd.chaos.step(i)``): fires kill and
        step-scheduled stall events for this rank."""
        for idx, e in enumerate(self.spec.events):
            if not (e.matches_rank(self.rank) and e.matches_step(step)):
                continue
            if e.kind == "kill":
                if self._already_fired(idx):
                    continue
                self._record_fired(idx)
                self._count("kill")
                self._mark("chaos.kill", step=step)
                log.warning("chaos: killing rank %d at step %d (exit %d)",
                            self.rank, step, e.exit_code)
                self._exit(e.exit_code)
            elif e.kind == "stall" and not e.point:
                self._count("stall")
                self._mark("chaos.stall.step", step=step,
                           duration_ms=e.duration_ms)
                self._sleep(e.duration_ms / 1000.0)

    def maybe_stall(self, point: str) -> None:
        """Named-point stall hook (straggler injection): e.g. the
        negotiated dispatch path calls ``maybe_stall("negotiate")`` so a
        stall event with that point slows every negotiated op on the
        target rank — which is what surfaces it by rank in the straggler
        report."""
        for e in self.spec.events:
            if (e.kind == "stall" and e.point == point
                    and e.matches_rank(self.rank)):
                self._count("stall")
                self._mark(f"chaos.stall.{point}",
                           duration_ms=e.duration_ms)
                self._sleep(e.duration_ms / 1000.0)

    def _nshards(self) -> int:
        if self._kv_shards is None:
            try:
                from ..common.knobs import current
                self._kv_shards = int(current("HOROVOD_KV_SHARDS"))
            except Exception:
                self._kv_shards = 1
        return self._kv_shards

    def maybe_fail_kv(self, op: str, scope: str = "") -> None:
        """Rendezvous-KV fault hook (runner/http_client.py): raises
        ``URLError`` for ``count`` matching KV operations — a simulated
        blackout window the client's bounded retry must ride through
        (or surface, if the window outlasts the budget).  An event
        carrying a ``scope`` blacks out only that KV scope (e.g.
        ``serve_plan`` — the serving plane's coordination channel); one
        carrying a ``shard`` blacks out every scope the deterministic
        map (runner/kvshard.py) assigns to that shard — the partial
        outage of one dark shard server, which must stall only the
        scopes it owns (docs/control-plane.md).  A kv_blackout's
        ``step`` is an op offset: the window opens after that many
        matching ops were observed.  Counters are per event, so
        concurrent windows ride independently."""
        for idx, e in enumerate(self.spec.events):
            if e.kind != "kv_blackout" or not e.matches_rank(self.rank):
                continue
            if e.op and e.op != op:
                continue
            if e.scope and e.scope != scope:
                continue
            if e.shard >= 0:
                from ..runner.kvshard import shard_for_scope
                if shard_for_scope(scope, self._nshards()) != e.shard:
                    continue
            seen = self._kv_seen.get(idx, 0)
            self._kv_seen[idx] = seen + 1
            if e.step >= 0 and seen < e.step:
                continue  # window not open yet (op-offset clock)
            failed = self._kv_failed.get(idx, 0)
            if failed < e.count:
                self._kv_failed[idx] = failed + 1
                self._count("kv_blackout")
                self._mark("chaos.kv_blackout", op=op, scope=scope,
                           shard=e.shard)
                import urllib.error
                raise urllib.error.URLError(
                    f"chaos: injected KV blackout event #{idx} "
                    f"({failed + 1}/{e.count}, scope={scope!r}, "
                    f"shard={e.shard})")

    def crash_point(self, point: str, step: Optional[int] = None) -> None:
        """Durability crash hook (elastic/fastcommit.py): a matching
        crash_commit event hard-exits HERE — between the data write and
        the durability marker — so the restore path's torn-commit promise
        is tested at its exact weak spot."""
        for idx, e in enumerate(self.spec.events):
            if e.kind != "crash_commit" or not e.matches_rank(self.rank):
                continue
            if not e.matches_step(step):
                continue
            if (e.point or "pre_marker") != point.rsplit(".", 1)[-1]:
                continue
            if self._already_fired(idx):
                continue
            self._record_fired(idx)
            self._count("crash_commit")
            self._mark("chaos.crash_commit", point=point)
            log.warning("chaos: crashing rank %d at %s (step %s)",
                        self.rank, point, step)
            self._exit(e.exit_code)
