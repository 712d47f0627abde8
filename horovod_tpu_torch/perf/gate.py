"""The perf regression gate: the port of ``horovod_tpu/perf/gate.py``,
a median +/- MAD comparison of benchmark artifacts against a baseline
ledger.

Every benchmark JSON row is keyed by its normalized metric and unit
(:func:`metric_key`); the baseline keeps the last
``MAX_BASELINE_VALUES`` values of each key; a new artifact fails when its
median sits outside the baseline's by more than ``mad_k`` scaled MADs AND
by more than ``min_rel_delta`` of it, in the worse direction.  A noisy
baseline tolerates jitter, a tight one does not fire on sub-percent
drift, and a 2x regression trips either way.

Command line, the counterpart of ``scripts/perf_gate.py``:

    python -m horovod_tpu_torch.perf.gate check  --baseline B.json a.json...
    python -m horovod_tpu_torch.perf.gate update --baseline B.json a.json...

``check`` exits 1 on any regression (improvements and keys without
history pass, and say so); ``update`` folds the artifacts' values into
the baseline (created when missing).  The port commits no baseline of its
own: ``PERF_BASELINE.json`` holds the JAX benchmark's numbers.

Standard library only.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Any, Dict, List, Optional, Tuple

BASELINE_SCHEMA = "hvd-perf-baseline-v1"
MAX_BASELINE_VALUES = 20  # rolling window per key

# 1.4826 rescales the MAD to the standard deviation of a normal
# distribution — the conventional robust sigma estimate.
MAD_SIGMA = 1.4826

# Units where a SMALLER value is better; everything else is
# higher-is-better (tokens/sec, images/sec, GB/s, efficiencies,
# fractions).  Artifact rows may override via "higher_is_better".
LOWER_IS_BETTER_UNITS = ("seconds", "step_time", "bytes", "ratio",
                        "error")


def metric_key(artifact: Dict[str, Any]) -> str:
    """Stable identity of a bench row across runs: the metric string
    with the run-specific parenthetical detail (loss values, chip name,
    per-size rates) stripped, plus the unit."""
    metric = str(artifact.get("metric", ""))
    metric = re.sub(r"\s*\(.*", "", metric).strip()
    metric = re.sub(r"\s+", " ", metric)
    return f"{metric} [{artifact.get('unit', '?')}]"


def higher_is_better(artifact: Dict[str, Any]) -> bool:
    if "higher_is_better" in artifact:
        return bool(artifact["higher_is_better"])
    unit = str(artifact.get("unit", "")).lower()
    return not any(tok in unit for tok in LOWER_IS_BETTER_UNITS)


def median_mad(values: List[float]) -> Tuple[float, float]:
    """(median, MAD) — the robust location/scale pair the gate judges
    with; MAD of a singleton is 0 (the relative floor then carries the
    decision alone)."""
    if not values:
        raise ValueError("median_mad of no values")
    vs = sorted(float(v) for v in values)
    n = len(vs)
    med = vs[n // 2] if n % 2 else 0.5 * (vs[n // 2 - 1] + vs[n // 2])
    devs = sorted(abs(v - med) for v in vs)
    mad = devs[n // 2] if n % 2 else 0.5 * (devs[n // 2 - 1]
                                            + devs[n // 2])
    return med, mad


def compare(baseline_values: List[float], current_values: List[float], *,
            higher_better: bool = True, mad_k: float = 4.0,
            min_rel_delta: float = 0.10) -> Dict[str, Any]:
    """One key's verdict: ``regression`` when the current median moved
    in the WORSE direction past both the ``mad_k``-scaled-MAD band and
    the ``min_rel_delta`` relative floor; ``improved`` symmetric in the
    better direction (informational — improvements never fail);
    ``pass`` otherwise."""
    base_med, base_mad = median_mad(baseline_values)
    cur_med, _ = median_mad(current_values)
    band = mad_k * MAD_SIGMA * base_mad
    floor = min_rel_delta * abs(base_med)
    threshold = max(band, floor)
    delta = cur_med - base_med
    worse = -delta if higher_better else delta
    status = "pass"
    if worse > threshold:
        status = "regression"
    elif -worse > threshold:
        status = "improved"
    return {"status": status,
            "baseline_median": base_med, "baseline_mad": base_mad,
            "current_median": cur_med, "delta": delta,
            "threshold": threshold,
            "ratio": (cur_med / base_med) if base_med else None,
            "n_baseline": len(baseline_values),
            "n_current": len(current_values)}


# ------------------------------------------------------------ ledger file
def empty_baseline() -> Dict[str, Any]:
    return {"schema": BASELINE_SCHEMA, "entries": {}}


def load_baseline(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != BASELINE_SCHEMA:
        raise ValueError(f"{path}: unknown baseline schema "
                         f"{doc.get('schema')!r} (want {BASELINE_SCHEMA})")
    return doc


def save_baseline(path: str, doc: Dict[str, Any]) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def load_artifacts(paths: List[str]) -> List[Dict[str, Any]]:
    """Benchmark artifacts: each file holds one JSON object (a
    benchmark's one printed line) or JSONL rows.  A row may carry
    ``sub_rows``, more gate-able rows riding the one printed line."""
    rows: List[Dict[str, Any]] = []

    def add(row: Dict[str, Any]) -> None:
        rows.append(row)
        for sub in row.get("sub_rows") or ():
            if isinstance(sub, dict):
                rows.append(sub)

    for path in paths:
        with open(path) as f:
            text = f.read().strip()
        if not text:
            continue
        try:
            add(json.loads(text))
            continue
        except ValueError:
            pass
        for line in text.splitlines():
            line = line.strip()
            if line.startswith("{"):
                add(json.loads(line))
    return rows


def gate_value(artifact: Dict[str, Any]) -> Optional[float]:
    """The number the gate judges for one artifact row.  BENCH_INVALID
    rows gate as None (an invalid bench is a separate failure, not a
    perf number)."""
    if "BENCH_INVALID" in str(artifact.get("metric", "")):
        return None
    v = artifact.get("value")
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def update_baseline(doc: Dict[str, Any],
                    artifacts: List[Dict[str, Any]]) -> List[str]:
    """Fold artifact values into the rolling per-key windows; returns
    the keys updated."""
    touched = []
    for art in artifacts:
        v = gate_value(art)
        if v is None:
            continue
        key = metric_key(art)
        entry = doc["entries"].setdefault(
            key, {"unit": art.get("unit"),
                  "higher_is_better": higher_is_better(art),
                  "values": [], "label": art.get("label", "")})
        entry["values"] = (entry["values"] + [v])[-MAX_BASELINE_VALUES:]
        touched.append(key)
    return touched


def check_artifacts(doc: Dict[str, Any],
                    artifacts: List[Dict[str, Any]], *,
                    mad_k: float = 4.0,
                    min_rel_delta: float = 0.10) -> Dict[str, Any]:
    """Gate a set of artifacts against a baseline ledger.  Keys absent
    from the baseline report ``no-baseline`` (a NEW bench mode must not
    fail the gate before it has history — run ``update`` to adopt it).
    Overall ``failed`` is true iff any key regressed."""
    by_key: Dict[str, List[float]] = {}
    for art in artifacts:
        v = gate_value(art)
        if v is not None:
            by_key.setdefault(metric_key(art), []).append(v)
    results: Dict[str, Any] = {}
    failed = False
    for key, values in sorted(by_key.items()):
        entry = doc["entries"].get(key)
        if not entry or not entry.get("values"):
            results[key] = {"status": "no-baseline",
                            "current_median": median_mad(values)[0]}
            continue
        res = compare(entry["values"], values,
                      higher_better=bool(entry.get("higher_is_better",
                                                   True)),
                      mad_k=mad_k, min_rel_delta=min_rel_delta)
        results[key] = res
        failed = failed or res["status"] == "regression"
    return {"failed": failed, "results": results}


# ---------------------------------------------------------- command line
def _print_results(res: Dict[str, Any]) -> None:
    for key, r in sorted(res["results"].items()):
        status = r["status"]
        if status == "no-baseline":
            print(f"  NO-BASELINE  {key}  (median "
                  f"{r['current_median']:.6g}; run `update` to adopt)")
            continue
        ratio = "n/a" if r["ratio"] is None else f"{r['ratio']:.3f}"
        print(f"  {status.upper():<12} {key}  baseline "
              f"{r['baseline_median']:.6g}+/-{r['baseline_mad']:.2g} -> "
              f"current {r['current_median']:.6g} "
              f"(ratio {ratio}, threshold +/-{r['threshold']:.2g})")


def _check(args) -> int:
    doc = load_baseline(args.baseline)
    artifacts = load_artifacts(args.artifacts)
    if not artifacts:
        print("perf gate: no artifacts to check", file=sys.stderr)
        return 2
    res = check_artifacts(doc, artifacts, mad_k=args.mad_k,
                          min_rel_delta=args.min_rel_delta)
    _print_results(res)
    if res["failed"]:
        print("perf gate: REGRESSION detected", file=sys.stderr)
        return 1
    print("perf gate: pass")
    return 0


def _update(args) -> int:
    doc = (load_baseline(args.baseline) if os.path.exists(args.baseline)
           else empty_baseline())
    touched = update_baseline(doc, load_artifacts(args.artifacts))
    save_baseline(args.baseline, doc)
    print(f"perf gate: updated {len(touched)} key(s) in {args.baseline}")
    for key in sorted(set(touched)):
        print(f"  {key}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.perf.gate",
        description="median +/- MAD perf regression gate over benchmark "
                    "artifacts")
    sub = ap.add_subparsers(dest="cmd")
    for name, fn in (("check", _check), ("update", _update)):
        p = sub.add_parser(name)
        p.add_argument("artifacts", nargs="+",
                       help="benchmark JSON artifact file(s) or JSONL")
        p.add_argument("--baseline", required=True,
                       help="baseline ledger (hvd-perf-baseline-v1)")
        p.add_argument("--mad-k", type=float, default=4.0)
        p.add_argument("--min-rel-delta", type=float, default=0.10)
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    if not getattr(args, "cmd", None):
        ap.print_help()
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
