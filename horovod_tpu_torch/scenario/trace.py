"""The port of ``horovod_tpu/scenario/trace.py``, byte for byte in what
it generates.

Workload-trace generators: seeded, wall-clock-free event streams.

Horovod's own validation ran a handful of static synthetic benchmarks
(arxiv 1802.05799); what that methodology misses is production
diversity — diurnal load, bursty arrivals, heavy-tailed prompts, faults
mid-burst.  This module turns those shapes into DATA: a scenario spec
names an arrival process and request-shape distributions, and the
generators here expand it into one deterministic event stream
(docs/scenarios.md).

Determinism contract (enforced by the ``scenario-determinism`` hvdlint
rule, the ``kvshard-determinism`` pattern):

  * no ``random``/``numpy`` RNG, no ``uuid``, no builtin ``hash()``, no
    environment reads, no wall-clock control flow, no set iteration —
    every draw comes from :class:`Stream`, a hand-rolled splitmix64
    generator whose state is pure u64 arithmetic;
  * every stream is derived from the ONE spec seed via the golden-ratio
    mix the chaos injector already uses
    (:func:`horovod_tpu_torch.chaos.injector.rank_stream_seed`), keyed by
    PURPOSE (phase index + role), never by rank — so the same spec
    yields a byte-identical event stream at 32 or 256 virtual ranks;
  * virtual-rank attribution is a separate pure function
    (:func:`rank_for`) applied at REPLAY time and excluded from the
    serialized stream;
  * event timestamps are rounded to microseconds before serialization
    (:func:`events_jsonl` — canonical JSON, sorted keys) so the bytes,
    not just the floats, are the comparison unit.
"""

from __future__ import annotations

import hashlib
import json
import math
from typing import Any, Dict, Iterable, List, Optional

from ..chaos.injector import rank_stream_seed

_MASK = (1 << 64) - 1
# FNV-1a 64-bit: string stream labels -> u64, independent of
# PYTHONHASHSEED (the kvshard discipline; builtin hash() is banned here).
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3

ARRIVAL_PROCESSES = ("constant", "poisson", "mmpp", "diurnal")


def _fnv1a64(text: str) -> int:
    h = _FNV_OFFSET
    for b in text.encode():
        h = ((h ^ b) * _FNV_PRIME) & _MASK
    return h


def stream_seed(seed: int, *parts) -> int:
    """Derive a sub-stream seed from the spec seed and a purpose key —
    the chaos injector's golden-ratio discipline, chained over parts.
    String parts hash via FNV-1a (never builtin ``hash``)."""
    s = seed & _MASK
    for p in parts:
        n = _fnv1a64(p) if isinstance(p, str) else int(p) & _MASK
        s = rank_stream_seed(s, n)
    return s


class Stream:
    """splitmix64 PRNG: the one randomness source scenario generators
    may draw from.  Pure u64 arithmetic (no ``random`` module), so two
    processes — or two interpreter versions — walk identical paths."""

    __slots__ = ("state",)

    def __init__(self, seed: int, *parts):
        self.state = stream_seed(seed, *parts)

    def next_u64(self) -> int:
        self.state = (self.state + 0x9E3779B97F4A7C15) & _MASK
        z = self.state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        return z ^ (z >> 31)

    def uniform(self) -> float:
        """[0, 1) with 53 bits — the float64-exact construction."""
        return (self.next_u64() >> 11) * (1.0 / (1 << 53))

    def expovariate(self, rate: float) -> float:
        """Exponential inter-arrival gap, mean 1/rate."""
        return -math.log1p(-self.uniform()) / rate

    def randint(self, lo: int, hi: int) -> int:
        """Uniform int in [lo, hi) (modulo bias is irrelevant for token
        synthesis and deterministic either way)."""
        return lo + self.next_u64() % max(1, hi - lo)


# ------------------------------------------------------- arrival processes
def arrival_times(stream: Stream, process: str, rate: float,
                  duration_s: float, *, t0: float = 0.0,
                  rate_high: float = 0.0, switch_s: float = 1.0,
                  burst_s: float = 0.0, amplitude: float = 0.5,
                  period_s: float = 0.0) -> List[float]:
    """Arrival timestamps in [t0, t0 + duration_s) for one process:

    * ``constant`` — a metronome at ``rate`` req/s;
    * ``poisson`` — exponential gaps at ``rate``;
    * ``mmpp`` — 2-state Markov-modulated Poisson burst: exponential
      holding times (mean ``switch_s`` calm, ``burst_s`` bursting, which
      defaults to ``switch_s/3``) switching between ``rate`` and
      ``rate_high`` (default 4x);
    * ``diurnal`` — a day's sinusoid compressed to ``period_s`` of bench
      time (default: the phase duration), thinned from the peak rate
      ``rate * (1 + amplitude)``.
    """
    if process not in ARRIVAL_PROCESSES:
        raise ValueError(f"unknown arrival process {process!r} "
                         f"(known: {ARRIVAL_PROCESSES})")
    if rate <= 0 or duration_s <= 0:
        return []
    end = t0 + duration_s
    out: List[float] = []
    if process == "constant":
        k = 0
        while t0 + k / rate < end:
            out.append(t0 + k / rate)
            k += 1
        return out
    if process == "poisson":
        t = t0
        while True:
            t += stream.expovariate(rate)
            if t >= end:
                return out
            out.append(t)
    if process == "mmpp":
        hi = rate_high if rate_high > 0 else 4.0 * rate
        calm_s = max(switch_s, 1e-6)
        hot_s = burst_s if burst_s > 0 else calm_s / 3.0
        t, bursting = t0, False
        next_switch = t0 + stream.expovariate(1.0 / calm_s)
        while t < end:
            gap = stream.expovariate(hi if bursting else rate)
            if t + gap >= next_switch:
                # exponential memorylessness: jumping to the switch
                # boundary and redrawing is distribution-exact
                t = next_switch
                bursting = not bursting
                hold = hot_s if bursting else calm_s
                next_switch = t + stream.expovariate(1.0 / hold)
                continue
            t += gap
            if t < end:
                out.append(t)
        return out
    # diurnal: Lewis-Shedler thinning against the peak rate
    period = period_s if period_s > 0 else duration_s
    peak = rate * (1.0 + amplitude)
    t = t0
    while True:
        t += stream.expovariate(peak)
        if t >= end:
            return out
        cur = rate * (1.0 + amplitude * math.sin(
            2.0 * math.pi * (t - t0) / period))
        if stream.uniform() * peak < cur:
            out.append(t)


# --------------------------------------------------------- request shapes
def heavy_tail_len(stream: Stream, mean: float, alpha: float,
                   lo: int, hi: int) -> int:
    """Bounded Pareto length with mean ~``mean``: the heavy-tailed
    prompt/output distribution real serving traffic shows (a few huge
    requests dominate the token budget).  ``alpha`` > 1 controls tail
    weight (smaller = heavier); values clamp into [lo, hi]."""
    x = (1.0 - stream.uniform()) ** (-1.0 / max(alpha, 1.001))
    val = lo + (mean - lo) * (alpha - 1.0) / alpha * x
    return max(lo, min(hi, int(val)))


def zipf_pick(stream: Stream, n: int, skew: float) -> int:
    """Zipf-weighted group index in [0, n): the shared-prefix skew the
    radix cache (serve/engine.py PrefixCache) is built to exploit —
    group 0 is hottest."""
    if n <= 1:
        return 0
    weights = [(k + 1) ** -skew for k in range(n)]
    u = stream.uniform() * math.fsum(weights)
    acc = 0.0
    for k in range(n):
        acc += weights[k]
        if u < acc:
            return k
    return n - 1


def group_prefix(seed: int, phase_idx: int, group: int, length: int,
                 vocab: int) -> List[int]:
    """The shared token prefix of one skew group: a pure function of
    (seed, phase, group), so every request in the group opens with the
    same bytes and the radix cache genuinely hits."""
    s = Stream(seed, "prefix", phase_idx, group)
    return [s.randint(0, vocab) for _ in range(length)]


# ------------------------------------------------------------ event stream
def phase_events(seed: int, phase_idx: int, phase: Dict[str, Any],
                 t0: float, vocab: int) -> List[Dict[str, Any]]:
    """Expand ONE phase into its events.  ``phase`` is the plain-dict
    phase config the scenario spec validated (scenario/spec.py):
    ``kind`` serve|train|mixed, ``duration_s``, ``arrivals`` (process
    params), ``shapes`` (length/prefix params), ``train_rate`` (train
    steps/s for train/mixed phases)."""
    kind = phase.get("kind", "serve")
    dur = float(phase["duration_s"])
    name = phase.get("name", f"phase{phase_idx}")
    events: List[Dict[str, Any]] = []
    if kind in ("serve", "mixed"):
        arr = dict(phase.get("arrivals") or {})
        process = arr.pop("process", "poisson")
        rate = float(arr.pop("rate", 0.0))
        astream = Stream(seed, "arrivals", phase_idx)
        times = arrival_times(astream, process, rate, dur, t0=t0, **{
            k: float(v) for k, v in arr.items()})
        sh = dict(phase.get("shapes") or {})
        sstream = Stream(seed, "shapes", phase_idx)
        p_mean = float(sh.get("prompt_mean", 12))
        p_alpha = float(sh.get("prompt_alpha", 2.0))
        p_lo = int(sh.get("prompt_min", 2))
        p_hi = int(sh.get("prompt_max", 48))
        o_mean = float(sh.get("output_mean", 8))
        o_alpha = float(sh.get("output_alpha", 2.5))
        o_lo = int(sh.get("output_min", 2))
        o_hi = int(sh.get("output_max", 32))
        groups = int(sh.get("prefix_groups", 0))
        skew = float(sh.get("prefix_skew", 1.2))
        frac = float(sh.get("prefix_frac", 0.5))
        prefixes: Dict[int, List[int]] = {}
        for k, t in enumerate(times):
            plen = heavy_tail_len(sstream, p_mean, p_alpha, p_lo, p_hi)
            olen = heavy_tail_len(sstream, o_mean, o_alpha, o_lo, o_hi)
            group = zipf_pick(sstream, groups, skew) if groups > 0 else -1
            if group >= 0:
                share = int(plen * frac)
                if group not in prefixes:
                    prefixes[group] = group_prefix(
                        seed, phase_idx, group, p_hi, vocab)
                prompt = prefixes[group][:share] + [
                    sstream.randint(0, vocab) for _ in range(plen - share)]
            else:
                prompt = [sstream.randint(0, vocab) for _ in range(plen)]
            events.append({"kind": "arrive", "t": round(t, 6),
                           "phase": name, "req": f"s{phase_idx}-{k}",
                           "group": group, "prompt": prompt,
                           "max_new": olen})
    if kind in ("train", "mixed"):
        train_rate = float(phase.get("train_rate", 0.0)) or (
            0.0 if kind == "mixed" else 10.0)
        if train_rate > 0:
            k = 0
            while t0 + k / train_rate < t0 + dur:
                events.append({"kind": "train", "phase": name,
                               "t": round(t0 + k / train_rate, 6),
                               "step": k})
                k += 1
    return events


def generate_events(seed: int, phases: List[Dict[str, Any]],
                    vocab: int = 256) -> List[Dict[str, Any]]:
    """The whole spec's event stream, time-ordered.  Phases run back to
    back; every draw derives from ``seed`` via per-purpose streams, so
    the output is independent of virtual rank count, process identity
    and dict/set iteration order (tests/test_scenario.py)."""
    events: List[Dict[str, Any]] = []
    t0 = 0.0
    for i, phase in enumerate(phases):
        events.extend(phase_events(seed, i, phase, t0, vocab))
        t0 += float(phase["duration_s"])
    events.sort(key=lambda e: (e["t"], 0 if e["kind"] == "train" else 1,
                               e.get("req", "")))
    return events


def events_jsonl(events: Iterable[Dict[str, Any]]) -> str:
    """Canonical serialization — THE byte-identity comparison unit:
    compact separators, sorted keys, microsecond-rounded times."""
    return "".join(json.dumps(e, sort_keys=True, separators=(",", ":"))
                   + "\n" for e in events)


def events_digest(events: Iterable[Dict[str, Any]]) -> str:
    return hashlib.sha256(events_jsonl(events).encode()).hexdigest()


def rank_for(index: int, nranks: int) -> int:
    """Virtual source rank of request ``index``: a pure golden-ratio
    scatter applied at REPLAY, never serialized — so the event stream's
    bytes cannot depend on the rank count."""
    return rank_stream_seed(0xC0FFEE, index) % max(1, nranks)


# --------------------------------------------------- named built-in traces
# The pre-scenario load generators, preserved by NAME so their perf rows
# stay comparable: bench.py --serve's open-loop leg historically ran
# Poisson at a fixed 60% of the measured closed-loop request rate.
BUILTIN_TRACES: Dict[str, Dict[str, Any]] = {
    "serve-bench-poisson": {"process": "poisson", "rate_factor": 0.6,
                            "seed": 0},
}


def builtin_arrivals(name: str, *, closed_loop_rps: float,
                     n: int) -> List[float]:
    """Count-bounded arrival schedule for a named built-in trace —
    bench.py --serve's one entry point into the arrival machinery."""
    cfg = BUILTIN_TRACES[name]
    rate = max(0.1, cfg["rate_factor"] * closed_loop_rps)
    stream = Stream(cfg["seed"], "builtin", name)
    out, t = [], 0.0
    for _ in range(n):
        t += stream.expovariate(rate)
        out.append(t)
    return out
