"""Serving-plane configuration: the port's own copy of
``horovod_tpu/serve/config.py``'s ``ServeConfig`` and ``from_knobs``, with
the same fields, defaults, validation and messages, and
``validate_serve_knobs``, the init-time check of the whole
``HOROVOD_SERVE_*`` surface (``runtime.py``).  Free of torch and of the
model, like the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static shape/budget contract of one continuous-batching engine.

    ``max_slots`` and ``prefill_chunk`` fix the compiled step's shapes
    (slot table height and chunk width); the knobs bound admission.
    """

    port: int = 0
    max_batch_tokens: int = 2048
    max_seq_len: int = 2048
    cache_blocks: int = 4096
    block_size: int = 16
    max_slots: int = 8
    prefill_chunk: int = 64
    eos_id: Optional[int] = None
    # Raw-speed legs (docs/serving.md#raw-speed).  All three preserve
    # greedy output exactly (prefix sharing reuses identical KV, chunking
    # is a scheduling change, speculative tokens are verified before
    # emission), so they default to the fast path; the knobs exist for
    # the degraded/off modes and for A/B measurement.
    prefix_cache: bool = True
    spec_decode: bool = True
    spec_k: int = 4
    # Replicated tier (docs/serving.md#replicated-tier): this fleet's
    # identity among N independent replica fleets behind one router,
    # the prefill/decode role split within a replica, and the host-RAM
    # spill capacity behind the device pool.  replica_id 0 keeps the
    # unscoped KV names, so a single fleet is byte-for-byte the
    # pre-replica deployment.
    replica_id: int = 0
    replicas: int = 1
    prefill_ranks: int = 0
    spill_blocks: int = 0

    @property
    def max_blocks_per_seq(self) -> int:
        return -(-self.max_seq_len // self.block_size)  # ceil

    def validate(self, model_max_seq: Optional[int] = None) -> None:
        if not (0 <= self.port <= 65535):
            raise ValueError(
                f"HOROVOD_SERVE_PORT={self.port} invalid; must be in "
                "[0, 65535] (0 = ephemeral; docs/serving.md)")
        for name, v in (("HOROVOD_SERVE_MAX_BATCH_TOKENS",
                         self.max_batch_tokens),
                        ("HOROVOD_SERVE_MAX_SEQ_LEN", self.max_seq_len),
                        ("HOROVOD_SERVE_CACHE_BLOCKS", self.cache_blocks)):
            if v <= 0:
                raise ValueError(
                    f"{name}={v} invalid; must be positive "
                    "(docs/serving.md)")
        if self.block_size <= 0 or self.max_slots <= 0:
            raise ValueError(
                f"serve block_size={self.block_size} / "
                f"max_slots={self.max_slots} invalid; must be positive")
        if self.prefill_chunk <= 0 or \
                self.prefill_chunk > self.max_batch_tokens:
            raise ValueError(
                f"HOROVOD_SERVE_PREFILL_CHUNK={self.prefill_chunk} "
                "invalid; must be in [1, max_batch_tokens="
                f"{self.max_batch_tokens}] (docs/serving.md)")
        if self.spec_k < 1:
            raise ValueError(
                f"HOROVOD_SERVE_SPEC_K={self.spec_k} invalid; the draft "
                "length must be >= 1 (docs/serving.md#raw-speed)")
        if self.spec_decode and self.spec_k + 1 > self.prefill_chunk:
            raise ValueError(
                f"HOROVOD_SERVE_SPEC_K={self.spec_k} exceeds the verify "
                f"row width: need spec_k + 1 <= prefill_chunk="
                f"{self.prefill_chunk} (the compiled step verifies the "
                "bonus token + K drafts in one row; docs/serving.md)")
        if self.replicas < 1:
            raise ValueError(
                f"HOROVOD_SERVE_REPLICAS={self.replicas} invalid; the "
                "replica tier needs >= 1 fleet "
                "(docs/serving.md#replicated-tier)")
        if not (0 <= self.replica_id < self.replicas):
            raise ValueError(
                f"HOROVOD_SERVE_REPLICA_ID={self.replica_id} invalid; "
                f"must be in [0, HOROVOD_SERVE_REPLICAS={self.replicas})"
                " (docs/serving.md#replicated-tier)")
        if self.prefill_ranks < 0:
            raise ValueError(
                f"HOROVOD_SERVE_PREFILL_RANKS={self.prefill_ranks} "
                "invalid; must be >= 0 (0 = colocated prefill+decode; "
                "docs/serving.md#replicated-tier)")
        if self.spill_blocks < 0:
            raise ValueError(
                f"HOROVOD_SERVE_SPILL_BLOCKS={self.spill_blocks} "
                "invalid; must be >= 0 (0 = spill off; "
                "docs/serving.md#replicated-tier)")
        if self.spill_blocks and not self.prefix_cache:
            raise ValueError(
                f"HOROVOD_SERVE_SPILL_BLOCKS={self.spill_blocks} needs "
                "the radix prefix cache on (HOROVOD_SERVE_PREFIX_CACHE); "
                "only tree-held cold blocks spill "
                "(docs/serving.md#replicated-tier)")
        if model_max_seq is not None and self.max_seq_len > model_max_seq:
            raise ValueError(
                f"HOROVOD_SERVE_MAX_SEQ_LEN={self.max_seq_len} exceeds "
                f"the served model's max_seq={model_max_seq}; RoPE "
                "tables end there (docs/serving.md)")


def _opt(knobs: Any, name: str, default: Any) -> Any:
    """Knob lookup tolerant of partial mappings (tests validate with
    plain dicts that predate the fault-tolerance/raw-speed knobs)."""
    try:
        return knobs[name]
    except (KeyError, TypeError):
        return default


def from_knobs(knobs: Any, **overrides: Any) -> ServeConfig:
    """Build a validated ServeConfig from a knob snapshot
    (common/knobs.Knobs or any mapping with __getitem__)."""
    kw = dict(
        port=int(knobs["HOROVOD_SERVE_PORT"]),
        max_batch_tokens=int(knobs["HOROVOD_SERVE_MAX_BATCH_TOKENS"]),
        max_seq_len=int(knobs["HOROVOD_SERVE_MAX_SEQ_LEN"]),
        cache_blocks=int(knobs["HOROVOD_SERVE_CACHE_BLOCKS"]),
        prefill_chunk=int(_opt(knobs, "HOROVOD_SERVE_PREFILL_CHUNK", 64)),
        prefix_cache=bool(_opt(knobs, "HOROVOD_SERVE_PREFIX_CACHE", True)),
        spec_decode=bool(_opt(knobs, "HOROVOD_SERVE_SPEC", True)),
        spec_k=int(_opt(knobs, "HOROVOD_SERVE_SPEC_K", 4)),
        replica_id=int(_opt(knobs, "HOROVOD_SERVE_REPLICA_ID", 0)),
        replicas=int(_opt(knobs, "HOROVOD_SERVE_REPLICAS", 1)),
        prefill_ranks=int(_opt(knobs, "HOROVOD_SERVE_PREFILL_RANKS", 0)),
        spill_blocks=int(_opt(knobs, "HOROVOD_SERVE_SPILL_BLOCKS", 0)),
    )
    kw.update(overrides)
    cfg = ServeConfig(**kw)
    cfg.validate()
    return cfg


def validate_serve_knobs(knobs: Any) -> None:
    """Init-time validation contract (runtime.py): a bad HOROVOD_SERVE_*
    value must fail hvd.init(), not a serving tick hours later."""
    from_knobs(knobs)
    drain = float(_opt(knobs, "HOROVOD_SERVE_DRAIN_TIMEOUT", 30.0))
    if drain <= 0:
        raise ValueError(
            f"HOROVOD_SERVE_DRAIN_TIMEOUT={drain} invalid; the drain "
            "budget must be positive seconds (docs/serving.md)")
    high = int(_opt(knobs, "HOROVOD_SERVE_SHED_HIGH", 0))
    low = int(_opt(knobs, "HOROVOD_SERVE_SHED_LOW", 0))
    if high < 0 or low < 0:
        raise ValueError(
            f"HOROVOD_SERVE_SHED_HIGH={high} / HOROVOD_SERVE_SHED_LOW="
            f"{low} invalid; shed watermarks must be >= 0 "
            "(docs/serving.md)")
    if high and low and low > high:
        raise ValueError(
            f"HOROVOD_SERVE_SHED_LOW={low} exceeds "
            f"HOROVOD_SERVE_SHED_HIGH={high}; hysteresis needs "
            "low <= high (docs/serving.md)")
    poll = float(_opt(knobs, "HOROVOD_SERVE_POLL_INTERVAL", 0.02))
    if poll <= 0:
        raise ValueError(
            f"HOROVOD_SERVE_POLL_INTERVAL={poll} invalid; the router's "
            "stream-probe interval must be positive seconds "
            "(docs/control-plane.md)")
    dead = float(_opt(knobs, "HOROVOD_SERVE_REPLICA_DEAD_S", 3.0))
    if dead <= 0:
        raise ValueError(
            f"HOROVOD_SERVE_REPLICA_DEAD_S={dead} invalid; the router's "
            "dark-replica threshold must be positive seconds "
            "(docs/serving.md#replicated-tier)")
