"""Autotuning of the fusion threshold and cycle time: the port of
``horovod_tpu/utils/autotune.py``.

The reference's ParameterManager runs Bayesian optimization over (fusion
threshold, cycle time) scoring bytes/sec, warms up, samples every N steps,
and logs to HOROVOD_AUTOTUNE_LOG (reference: parameter_manager.{h,cc},
common.h:70-75 knobs).  The native math lives in the port's copy of the
core (``csrc/core/optim.cc``); this wrapper feeds it step measurements
from the training loop and republishes the tuned fusion threshold to the
bucket planner: ``Runtime.fusion_threshold()`` returns it, and the fused
gradient sync (``optimizer.py``) re-plans its buckets when it changes.

Cross-process consistency: every process must hold the same threshold or
their bucket plans diverge.  Like the reference (rank 0 tunes, then
broadcasts: controller.cc:39-53 SynchronizeParameters), only process 0
runs the optimizer; its tuned values reach every process on every
record() until tuning completes, over the runtime's ``torch.distributed``
group (a CUDA tensor under NCCL).  record() is therefore collective: call
it once per step on every process.  A process that skips it leaves the
others' exchange unanswered, and that exchange raises after
``sync_timeout_s`` (or as soon as the backend sees the peer gone) instead
of hanging; the exchange also carries each process's record count, so one
paired with another process's different call fails on every process.

For the negotiated path the same machinery runs inside the native core's
cycle loop (``csrc/core``), enabled by the HOROVOD_AUTOTUNE knob.

Usage::

    hvd.init()                 # HOROVOD_AUTOTUNE=1 in env
    tuner = hvd.autotuner()
    for batch in data:
        with tuner.measure(nbytes=grad_bytes):
            step(batch)        # blocks until the step is done
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np

from ..common import hvdlogging as log
from ..common.basics import NativeParameterManager


class Autotuner:
    """Feeds step measurements into the native parameter manager and exposes
    the live fusion threshold (reference: ParameterManager::Update).

    With ``policy_arms`` (HOROVOD_WIRE_POLICY=auto), the wire-policy
    dimension joins the search: a deterministic UCB1 bandit
    (csrc/optim.cc ArmBandit) over the arm names, scored like the GP in
    effective bytes/sec.  The categorical axis stays OFF the GP — its RBF
    kernel would invent distances between unrelated policies.  With
    ``depth_arms`` (HOROVOD_OVERLAP on), the overlap pipeline depth
    (ops/overlap.py) is a second arm dimension; when both are present
    the two are searched JOINTLY over the product space (csrc/optim.cc
    ProductBandit — the best depth depends on the policy, since a
    compressed wire shortens exactly the sync the pipeline hides).  The
    chosen arm indices ride the same rank-0 broadcast as the threshold,
    so every process plans identical buckets."""

    def __init__(self, knobs, process_rank: int = 0, process_size: int = 1,
                 policy_arms=None, depth_arms=None, device=None,
                 sync_timeout_s: float = 60.0):
        self._process_rank = process_rank
        self._process_size = process_size
        self._device = device  # where the exchange's tensor lives
        self._sync_timeout_s = float(sync_timeout_s)
        self._records = 0
        self._threshold = int(knobs["HOROVOD_FUSION_THRESHOLD"])
        self._cycle_ms = float(knobs["HOROVOD_CYCLE_TIME"])
        self._done = False
        self._pm = None
        self._arms = tuple(policy_arms) if policy_arms else ()
        self._depths = tuple(int(d) for d in depth_arms) if depth_arms \
            else ()
        self._policy_arm = 0
        self._depth_arm = 0
        self._bandit = None
        self._bandit_kind = None
        if process_rank == 0:
            self._pm = NativeParameterManager(
                initial_threshold=self._threshold,
                initial_cycle_ms=self._cycle_ms,
                warmup_samples=knobs["HOROVOD_AUTOTUNE_WARMUP_SAMPLES"],
                steps_per_sample=knobs["HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE"],
                max_samples=knobs["HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES"],
                gp_noise=knobs["HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE"])
            sps = knobs["HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE"]
            n_pol, n_dep = len(self._arms), len(self._depths)
            if n_pol > 1 and n_dep > 1:
                from ..common.basics import NativeProductBandit
                self._bandit = NativeProductBandit(
                    n_pol, n_dep, steps_per_sample=sps,
                    max_pulls=4 * n_pol * n_dep)
                self._bandit_kind = "product"
            elif n_pol > 1:
                from ..common.basics import NativeArmBandit
                self._bandit = NativeArmBandit(n_pol, steps_per_sample=sps,
                                               max_pulls=4 * n_pol)
                self._bandit_kind = "policy"
            elif n_dep > 1:
                from ..common.basics import NativeArmBandit
                self._bandit = NativeArmBandit(n_dep, steps_per_sample=sps,
                                               max_pulls=4 * n_dep)
                self._bandit_kind = "depth"
        self._log_fh = None
        log_path = knobs["HOROVOD_AUTOTUNE_LOG"]
        if log_path and process_rank == 0:
            fresh = not (os.path.exists(log_path) and
                         os.path.getsize(log_path) > 0)
            self._log_fh = open(log_path, "a")
            if fresh:
                self._log_fh.write(
                    "threshold_bytes,cycle_ms,best_score_bytes_per_s\n")

    @property
    def fusion_threshold(self) -> int:
        return self._threshold

    @property
    def cycle_ms(self) -> float:
        return self._cycle_ms

    @property
    def done(self) -> bool:
        return self._done

    @property
    def best_score(self) -> float:
        return self._pm.best_score if self._pm is not None else 0.0

    @property
    def wire_policy(self) -> Optional[str]:
        """The current wire-policy arm name, or None when the policy
        dimension is not being tuned (consumed by Runtime.wire_policy)."""
        if not self._arms:
            return None
        return self._arms[self._policy_arm]

    @property
    def overlap_depth(self) -> Optional[int]:
        """The current overlap-depth arm value, or None when the depth
        dimension is not being tuned (consumed by
        Runtime.overlap_depth)."""
        if not self._depths:
            return None
        return self._depths[self._depth_arm]

    def _sync(self) -> None:
        """Give every process process 0's (threshold, cycle, done, policy
        arm, depth arm), so every process plans identical buckets, wire
        formats and pipeline depths.  No-op single-process.

        One allgather of six float64 per process over the runtime's group
        (each row: the process's record count, then its five values; the
        values of row 0 win): every process checks every count, and the
        wait is bounded by ``sync_timeout_s``."""
        if self._process_size <= 1:
            return
        import torch
        import torch.distributed as dist
        mine = torch.tensor([float(self._records), float(self._threshold),
                             self._cycle_ms, 1.0 if self._done else 0.0,
                             float(self._policy_arm),
                             float(self._depth_arm)], dtype=torch.float64,
                            device=self._device)
        rows = mine.new_empty(self._process_size * mine.numel())
        work = dist.all_gather_into_tensor(rows, mine, async_op=True)
        deadline = time.monotonic() + self._sync_timeout_s
        while not work.is_completed():
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"autotune: the exchange of record {self._records} did "
                    f"not complete within {self._sync_timeout_s} s; every "
                    "process must call record() once per step")
            time.sleep(1e-4)
        work.wait()
        vals = rows.view(self._process_size, -1).cpu().tolist()
        counts = [int(r[0]) for r in vals]
        if len(set(counts)) != 1:
            raise RuntimeError(
                f"autotune: processes are at different record() calls "
                f"{counts}; every process must call record() once per step")
        v = vals[0]
        self._threshold = int(v[1])
        self._cycle_ms = float(v[2])
        self._done = bool(v[3])
        self._policy_arm = int(v[4])
        self._depth_arm = int(v[5])

    def record(self, nbytes: int, seconds: float) -> bool:
        """Record one step's traffic; returns True when tunables changed
        (threshold, cycle, or wire-policy arm — any of which means the
        caller should re-trace).  Collective across processes while tuning
        is live."""
        if self._done:
            return False
        self._records += 1
        changed = False
        if self._pm is not None:
            if not self._pm.done:
                changed = self._pm.update(nbytes, seconds)
                self._threshold = self._pm.threshold
                self._cycle_ms = self._pm.cycle_ms
                if changed and self._log_fh:
                    self._log_fh.write(
                        f"{self._threshold},{self._cycle_ms:.3f},"
                        f"{self._pm.best_score:.1f}\n")
                    self._log_fh.flush()
            if self._bandit is not None and not self._bandit.done:
                # Same score the GP sees: logical payload bytes per second
                # — a compressed wire moves the same payload faster, so
                # "effective bytes/sec" rewards the formats that help and
                # punishes quantize/cast overhead that doesn't pay off.
                if self._bandit.update(nbytes / max(seconds, 1e-12)):
                    changed = True
                if self._bandit_kind == "product":
                    self._policy_arm = self._bandit.arm_a
                    self._depth_arm = self._bandit.arm_b
                elif self._bandit_kind == "policy":
                    self._policy_arm = self._bandit.arm
                else:
                    self._depth_arm = self._bandit.arm
            self._done = self._pm.done and (
                self._bandit is None or self._bandit.done)
            if changed:
                log.debug("autotune: threshold=%d cycle=%.2fms policy=%s "
                          "depth=%s done=%s", self._threshold,
                          self._cycle_ms, self.wire_policy,
                          self.overlap_depth, self._done)
        self._sync()
        return changed

    @contextlib.contextmanager
    def measure(self, nbytes: int):
        """Context manager timing one (blocking) training step."""
        t0 = time.monotonic()
        yield
        self.record(nbytes, time.monotonic() - t0)

    def close(self) -> None:
        if self._log_fh:
            self._log_fh.close()
            self._log_fh = None
