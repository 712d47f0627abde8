"""The cost model: the port's copy of the parts of
``horovod_tpu/perf/costmodel.py`` that the ZeRO chain and the 3D layout
plane use.  Plain arithmetic, no framework:

  * the hardware tables (``PEAK_TFLOPS``, ``LINK_GBPS``), with the H100's
    own entries beside the JAX package's;
  * the FLOP and parameter counts (``train_flops_per_token``,
    ``llama_param_count``);
  * the ZeRO chain's per-rank wire bytes (``zero_comm_bytes``) and
    resident bytes (``zero_memory_bytes``);
  * the layout solver (``parallel/layout.py``): ``tp_comm_bytes``,
    ``pp_comm_bytes``, ``layout_memory_bytes``, ``layout_step_time``,
    ``enumerate_layouts``, ``solve_layout`` and ``llama_layout_model``;
  * the perf plane's pricing (``perf/ledger.py``): the MoE parameter
    counts, the roofline ``predicted_step_time``, the ZeRO what-if table
    ``zero_level_table``, the plan-cache comm leg ``plan_comm_bytes`` over
    the port's fusion plan and wire model, and ``compiled_flops``.

``compiled_flops`` is where the port departs: the JAX function reads
XLA's ``cost_analysis()`` of the jitted call; the port runs the call once
under ``torch.utils.flop_counter.FlopCounterMode``.  The counter sees the
aten operators, not the Hopper attention kernels, which run behind
``ops/flash_attention.py``'s autograd Function through ``ctypes``; so the
attention is counted beside the counter, by the Function itself, with the
formula of :func:`attention_flops`, and whatever the counter saw inside
the Function (the plain path's products on the CPU) is taken out."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------- hardware
# Dense bf16 peak TFLOP/s per chip.  The TPU entries are the JAX package's
# (public spec sheets); 'cpu' is nominal so CPU runs give a finite ratio;
# 'h100' is the H100 SXM's dense bf16 tensor-core rate.
PEAK_TFLOPS: Dict[str, float] = {
    "v4": 275.0,
    "v5e": 197.0,
    "v5p": 459.0,
    "v6e": 918.0,
    "cpu": 0.5,
    "h100": 989.0,
}

# Per-chip link bandwidth by fabric class, GB/s, one direction.  The
# JAX package's entries, and 'nvlink': NVLink 4 on the H100 SXM, 900 GB/s
# bidirectional per GPU (NVIDIA H100 Tensor Core GPU datasheet, SXM5
# column), so 450 GB/s each way.
LINK_GBPS: Dict[str, float] = {
    "ici": 100.0,
    "dcn": 6.25,
    "loopback": 10.0,
    "nvlink": 450.0,
}
LINK_CLASSES = tuple(sorted(LINK_GBPS))


def peak_flops(chip: str) -> float:
    """Chip name -> peak FLOP/s (falls back to v5e, as the JAX package
    does)."""
    return PEAK_TFLOPS.get(chip, PEAK_TFLOPS["v5e"]) * 1e12


def link_bandwidth(link: str) -> float:
    """Link class name -> bytes/s."""
    if link not in LINK_GBPS:
        raise ValueError(
            f"unknown link class {link!r}; valid: {', '.join(LINK_CLASSES)}")
    return LINK_GBPS[link] * 1e9


# ------------------------------------------------------------------- flops
def train_flops_per_token(n_params: int,
                          attention: Optional[Dict[str, Any]] = None
                          ) -> float:
    """Training FLOPs per token: ``6 * N`` (2N forward, 4N backward, the
    attention score and value products excluded).  ``attention={"n_layers",
    "dim", "seq", "causal"}`` adds ``12 * n_layers * seq * dim``, halved
    when causal (the default)."""
    flops = 6.0 * float(n_params)
    if attention:
        attn = (12.0 * float(attention["n_layers"])
                * float(attention["seq"]) * float(attention["dim"]))
        if attention.get("causal", True):
            attn *= 0.5
        flops += attn
    return flops


def llama_param_count(vocab: int, dim: int, n_layers: int, n_heads: int,
                      n_kv_heads: int, ffn_dim: int) -> int:
    """Exact parameter count of the Llama model from its config shapes."""
    head_dim = dim // n_heads
    per_layer = (
        dim * n_heads * head_dim            # wq
        + 2 * dim * n_kv_heads * head_dim   # wk, wv
        + n_heads * head_dim * dim          # wo
        + 3 * dim * ffn_dim                 # w_gate, w_up, w_down
        + 2 * dim                           # attn_norm, ffn_norm
    )
    return (vocab * dim + n_layers * per_layer + dim + dim * vocab)


def moe_llama_param_count(vocab: int, dim: int, n_layers: int,
                          n_heads: int, n_kv_heads: int, moe_hidden: int,
                          n_experts: int) -> int:
    """Exact parameter count of the MoE Llama (``models/moe_llama.py``):
    the Llama attention blocks with the dense FFN replaced by the router
    and the stacked expert FFNs."""
    head_dim = dim // n_heads
    per_layer = (
        dim * n_heads * head_dim
        + 2 * dim * n_kv_heads * head_dim
        + n_heads * head_dim * dim
        + 2 * dim                                  # attn_norm, ffn_norm
        + dim * n_experts                          # router
        + 2 * n_experts * dim * moe_hidden         # wi, wo
    )
    return vocab * dim + n_layers * per_layer + dim + dim * vocab


def moe_llama_active_param_count(vocab: int, dim: int, n_layers: int,
                                 n_heads: int, n_kv_heads: int,
                                 moe_hidden: int, n_experts: int,
                                 experts_per_token: int) -> int:
    """Parameters one token's forward touches (the N of 6N for a MoE
    model): every non-expert weight plus ``experts_per_token`` expert FFNs
    a layer."""
    total = moe_llama_param_count(vocab, dim, n_layers, n_heads,
                                  n_kv_heads, moe_hidden, n_experts)
    inactive_experts = n_experts - experts_per_token
    return total - n_layers * 2 * inactive_experts * dim * moe_hidden


def ring_wire_bytes(nelems: int, itemsize: float, n: int) -> float:
    """Per-chip wire bytes of one ring allreduce: 2(n-1) chunks of
    ceil(nelems/n) elements."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) * math.ceil(nelems / n) * itemsize


def predicted_step_time(flops: float, comm_bytes: float, *,
                        chip: str = "cpu", link: str = "loopback",
                        overlap_fraction: float = 0.0,
                        input_seconds: float = 0.0) -> Dict[str, Any]:
    """Roofline predicted step, in seconds: ``compute`` is flops over the
    chip's peak, ``exposed_comm`` the non-overlapped share of the comm
    bytes over the link class's bandwidth, and ``step`` adds the host
    input time.  A prediction; the ledger records its drift from the
    measured step."""
    if not 0.0 <= overlap_fraction <= 1.0:
        raise ValueError(
            f"overlap_fraction {overlap_fraction} outside [0, 1]")
    compute = float(flops) / peak_flops(chip)
    exposed = (float(comm_bytes) * (1.0 - overlap_fraction)
               / link_bandwidth(link))
    return {
        "compute_s": compute,
        "exposed_comm_s": exposed,
        "host_input_s": float(input_seconds),
        "step_s": compute + exposed + float(input_seconds),
        "chip": chip,
        "link": link,
    }


# Wire itemsize per reduce-scatter-leg format (bytes per element on the
# wire), the ops/wire.py formats' table.
WIRE_ITEMSIZE: Dict[str, float] = {
    "none": 4.0, "bf16": 2.0, "fp16": 2.0,
    "int8_ring": 1.0, "dcn_int8": 1.0,
}
ZERO_LEVELS = (0, 1, 2, 3)


def _ring_half_leg(n: int, nelems: float, itemsize: float) -> float:
    """One reduce_scatter OR all_gather leg of the ring, per rank: (n-1)
    chunks of ceil(nelems/n) elements (half of a ring allreduce)."""
    if n <= 1:
        return 0.0
    return (n - 1) * math.ceil(nelems / n) * itemsize


def zero_comm_bytes(nelems: float, world: int, level: int, *,
                    k: int = 1, wire_format: str = "none",
                    itemsize: float = 4.0) -> Dict[str, float]:
    """Per-rank modeled wire bytes of ONE optimizer step of the ZeRO chain,
    the reduce-scatter (RS) and all-gather (AG) legs priced separately:

      level 0  plain data parallelism: accumulate k microbatches locally,
               one allreduce (both ring phases at the wire itemsize);
      level 1  k per-microbatch syncs; at k > 1 each shard is gathered
               back to keep the full gradient accumulator, plus the update
               all-gather;
      level 2  k reduce-scatters onto the resident shard + one update
               all-gather;
      level 3  k reduce-scatters + one parameter all-gather at step start
               (the same bytes as level 2).

    The RS leg carries ``wire_format``'s itemsize; AG legs are exact
    (``itemsize``)."""
    if level not in ZERO_LEVELS:
        raise ValueError(f"zero level {level} invalid; must be one of "
                         f"{ZERO_LEVELS}")
    n = int(world)
    enc = WIRE_ITEMSIZE.get(wire_format, itemsize)
    rs = _ring_half_leg(n, nelems, enc)
    ag = _ring_half_leg(n, nelems, itemsize)
    if level == 0:
        rs_total, ag_total = rs, _ring_half_leg(n, nelems, enc)
    elif level == 1:
        rs_total = k * rs
        ag_total = (k + 1) * ag if k > 1 else ag
    else:
        rs_total, ag_total = k * rs, ag
    return {"rs_bytes": rs_total, "ag_bytes": ag_total,
            "total_bytes": rs_total + ag_total}


def zero_memory_bytes(level: int, n_params: float, world: int, *,
                      opt_slots: int = 2, ef: bool = False,
                      itemsize: float = 4.0) -> Dict[str, int]:
    """Per-rank resident bytes of the training state under a ZeRO level:
    parameters, the gradient accumulator, the optimizer state
    (``opt_slots`` parameter-sized buffers, 2 for Adam's moments) and the
    error-feedback residual (full size per rank when on).  Level 0 is plain
    data parallelism."""
    if level not in ZERO_LEVELS:
        raise ValueError(f"zero level {level} invalid; must be one of "
                         f"{ZERO_LEVELS}")
    n = max(int(world), 1)
    p = float(n_params) * itemsize
    out = {
        "params_bytes": p / n if level >= 3 else p,
        "grads_bytes": p / n if level >= 2 else p,
        "opt_state_bytes": (p * opt_slots / n if level >= 1
                            else p * opt_slots),
        "ef_residual_bytes": p if ef else 0.0,
    }
    out = {key: int(v) for key, v in out.items()}
    out["total_bytes"] = sum(out.values())
    return out


def zero_level_table(n_params: float, world: int, *,
                     opt_slots: int = 2, k: int = 1,
                     wire_format: str = "none", ef: bool = False,
                     chip: str = "cpu", link: str = "loopback",
                     flops_per_step: Optional[float] = None
                     ) -> List[Dict[str, Any]]:
    """The "what would ZeRO-N cost me here" table: one row per level with
    the per-rank memory, the step's wire bytes split RS/AG, the exposed
    comm seconds on ``link`` and, when ``flops_per_step`` is known, the
    roofline predicted step.  The perf report carries it beside the
    measured decomposition."""
    rows = []
    for level in ZERO_LEVELS:
        comm = zero_comm_bytes(n_params, world, level, k=k,
                               wire_format=wire_format)
        row: Dict[str, Any] = {
            "level": level,
            "memory": zero_memory_bytes(level, n_params, world,
                                        opt_slots=opt_slots, ef=ef),
            "comm": {key: int(v) for key, v in comm.items()},
            "exposed_comm_s": comm["total_bytes"] / link_bandwidth(link),
        }
        if flops_per_step:
            row["predicted"] = predicted_step_time(
                flops_per_step, comm["total_bytes"], chip=chip, link=link)
        rows.append(row)
    return rows


# ------------------------------------------------------- 3D layout solver
# Enumerate the (dp, tp, pp, zero_level, wire, overlap_depth)
# factorizations of the world, price each with the roofline terms above,
# filter by a per-chip memory cap and rank by predicted step time.
LAYOUT_AXES = ("dp", "tp", "pp")

# Live activation bytes per token per resident layer, in units of
# dim * itemsize: residual stream, normed input, attention output and the
# ffn intermediate held for the backward.  A small-constant model, not a
# measurement.
ACTIVATION_MULT = 4.0


def tp_comm_bytes(tp: int, tokens: float, dim: int, n_layers: int, *,
                  itemsize: float = 4.0) -> float:
    """Per-chip wire bytes of Megatron tensor parallelism for one step:
    each layer all-reduces the ``[tokens, dim]`` activation twice in the
    forward (after wo and w_down) and twice in the backward (the f
    operators at the column-parallel inputs)."""
    if tp <= 1:
        return 0.0
    return 4.0 * n_layers * ring_wire_bytes(tokens * dim, itemsize, tp)


def pp_comm_bytes(pp: int, n_micro: int, mb_tokens: float, dim: int, *,
                  itemsize: float = 4.0) -> float:
    """Per-chip wire bytes of the GPipe schedule for one step: one shift of
    a ``[mb_tokens, dim]`` activation per tick, ``n_micro + pp - 1`` ticks,
    forward and backward."""
    if pp <= 1:
        return 0.0
    return 2.0 * (n_micro + pp - 1) * mb_tokens * dim * itemsize


def _effective_microbatches(local_batch: int, requested: int) -> int:
    """Largest divisor of ``local_batch`` that is <= ``requested``: the
    GPipe microbatch count a (dp, pp) candidate can run."""
    m = max(1, min(int(requested), int(local_batch)))
    while m > 1 and local_batch % m:
        m -= 1
    return m


def layout_memory_bytes(model: Dict[str, Any], dp: int, tp: int, pp: int,
                        *, zero_level: int = 1, ef: bool = False,
                        opt_slots: int = 2) -> Dict[str, int]:
    """Per-chip resident bytes under a (dp, tp, pp) layout: the ZeRO
    state priced on this chip's ``n_params / (tp * pp)`` slice over the dp
    subgroup, plus the activations (batch/dp rows times the layers of this
    stage; the residual stream is replicated over tp)."""
    itemsize = float(model.get("itemsize", 4.0))
    n_local = float(model["n_params"]) / (tp * pp)
    out = dict(zero_memory_bytes(zero_level, n_local, dp,
                                 opt_slots=opt_slots, ef=ef,
                                 itemsize=itemsize))
    total = out.pop("total_bytes")
    batch = float(model.get("batch", dp))
    seq = float(model.get("seq", 1))
    n_layers = float(model.get("n_layers", 1))
    act = (batch / dp) * seq * (n_layers / pp) \
        * float(model.get("dim", 0)) * ACTIVATION_MULT * itemsize
    out["activation_bytes"] = int(act)
    out["total_bytes"] = int(total + act)
    return out


def layout_step_time(model: Dict[str, Any], dp: int, tp: int, pp: int, *,
                     zero_level: int = 1, k: int = 1,
                     wire_format: str = "none", overlap_depth: int = 0,
                     n_micro: int = 4, chip: str = "cpu",
                     link: str = "loopback", ef: bool = False,
                     opt_slots: int = 2) -> Dict[str, Any]:
    """Predicted step of one (dp, tp, pp) candidate:

      compute        the model's FLOPs over all dp*tp*pp chips;
      tp_comm        4 activation all-reduces per layer over the tp ring;
      pp_comm        the GPipe shifts;
      bubble         (S-1)/(M+S-1) inflates compute and tp comm;
      zero_comm      the chain's legs on the n_params/(tp*pp) slice over
                     the dp subgroup; level 3's gathers hide behind the
                     forward with a prefetch window, depth d exposing ag/d.

    Every term is priced on one ``link`` class; memory comes from
    :func:`layout_memory_bytes`."""
    itemsize = float(model.get("itemsize", 4.0))
    bw = link_bandwidth(link)
    seq = float(model.get("seq", 1))
    batch = float(model.get("batch", dp))
    n_layers = int(model.get("n_layers", 1))
    dim = int(model.get("dim", 0))
    local_rows = batch / dp
    m = _effective_microbatches(int(local_rows), n_micro) if pp > 1 else 1
    compute_s = (float(model.get("flops_per_step", 0.0))
                 / (peak_flops(chip) * dp * tp * pp))
    tp_s = tp_comm_bytes(tp, local_rows * seq, dim,
                         n_layers // pp if pp > 1 else n_layers,
                         itemsize=itemsize) / bw
    pp_s = pp_comm_bytes(pp, m, (local_rows / m) * seq, dim,
                         itemsize=itemsize) / bw
    bubble = (pp - 1) / (m + pp - 1) if pp > 1 else 0.0
    comm = zero_comm_bytes(float(model["n_params"]) / (tp * pp), dp,
                           zero_level, k=k, wire_format=wire_format,
                           itemsize=itemsize)
    rs_s = comm["rs_bytes"] / bw
    ag_s = comm["ag_bytes"] / bw
    if zero_level >= 3 and overlap_depth > 0:
        ag_s /= overlap_depth
    zero_s = rs_s + ag_s
    step_s = (compute_s + tp_s) / (1.0 - bubble) + pp_s + zero_s
    return {
        "layout": {"dp": dp, "tp": tp, "pp": pp},
        "zero_level": int(zero_level),
        "wire_format": wire_format,
        "overlap_depth": int(overlap_depth),
        "n_micro": int(m),
        "bubble_fraction": bubble,
        "compute_s": compute_s,
        "tp_comm_s": tp_s,
        "pp_comm_s": pp_s,
        "zero_comm_s": zero_s,
        "step_s": step_s,
        "memory": layout_memory_bytes(model, dp, tp, pp,
                                      zero_level=zero_level, ef=ef,
                                      opt_slots=opt_slots),
        "chip": chip,
        "link": link,
    }


def _factorizations(world: int):
    for dp in range(1, world + 1):
        if world % dp:
            continue
        rest = world // dp
        for tp in range(1, rest + 1):
            if rest % tp:
                continue
            yield dp, tp, rest // tp


def enumerate_layouts(model: Dict[str, Any], world: int, *,
                      levels=(1, 2, 3), wires=("none",),
                      overlap_depths=(0,), k: int = 1, n_micro: int = 4,
                      chip: str = "cpu", link: str = "loopback",
                      ef: bool = False) -> List[Dict[str, Any]]:
    """Every valid candidate at ``world`` chips: dp*tp*pp == world, tp
    divides n_heads and n_kv_heads, pp divides n_layers, dp divides the
    global batch.  ``overlap_depths`` fans out at level 3 only."""
    n_heads = int(model.get("n_heads", 1))
    n_kv = int(model.get("n_kv_heads", n_heads))
    n_layers = int(model.get("n_layers", 1))
    batch = int(model.get("batch", world))
    rows = []
    for dp, tp, pp in _factorizations(int(world)):
        if n_heads % tp or n_kv % tp or n_layers % pp or batch % dp:
            continue
        for level in levels:
            for wire in wires:
                depths = overlap_depths if level >= 3 else (0,)
                for depth in depths:
                    rows.append(layout_step_time(
                        model, dp, tp, pp, zero_level=level, k=k,
                        wire_format=wire, overlap_depth=depth,
                        n_micro=n_micro, chip=chip, link=link, ef=ef))
    return rows


def solve_layout(model: Dict[str, Any], world: int, *,
                 mem_cap_bytes: Optional[float] = None,
                 levels=(1, 2, 3), wires=("none",), overlap_depths=(0,),
                 k: int = 1, n_micro: int = 4, chip: str = "cpu",
                 link: str = "loopback", ef: bool = False
                 ) -> Dict[str, Any]:
    """The ``HOROVOD_LAYOUT=auto`` decision: the candidates of
    :func:`enumerate_layouts` ranked memory-fits first, then by predicted
    step (ties: fewer pipeline stages, then less tensor parallelism).
    Returns the ranked table and the chosen row; ``chosen["fits"]`` is
    False only when nothing fits."""
    rows = enumerate_layouts(model, world, levels=levels, wires=wires,
                             overlap_depths=overlap_depths, k=k,
                             n_micro=n_micro, chip=chip, link=link, ef=ef)
    if not rows:
        raise ValueError(
            f"no valid (dp, tp, pp) factorization of world={world} for "
            "this model (check n_heads/n_kv_heads/n_layers/batch "
            "divisibility)")
    for row in rows:
        row["fits"] = (mem_cap_bytes is None
                       or row["memory"]["total_bytes"] <= mem_cap_bytes)
    rows.sort(key=lambda r: (not r["fits"], r["step_s"],
                             r["layout"]["pp"], r["layout"]["tp"]))
    for rank, row in enumerate(rows, start=1):
        row["rank"] = rank
    return {
        "world": int(world),
        "mem_cap_bytes": (int(mem_cap_bytes)
                          if mem_cap_bytes is not None else None),
        "n_candidates": len(rows),
        "chosen": rows[0],
        "candidates": rows,
    }


def llama_layout_model(*, vocab: int, dim: int, n_layers: int,
                       n_heads: int, n_kv_heads: int, ffn_dim: int,
                       batch: int, seq: int,
                       itemsize: float = 4.0) -> Dict[str, Any]:
    """The model descriptor :func:`solve_layout` takes, from Llama config
    shapes: the exact parameter count and the 6N FLOPs convention."""
    n_params = llama_param_count(vocab, dim, n_layers, n_heads,
                                 n_kv_heads, ffn_dim)
    return {
        "family": "llama",
        "n_params": n_params,
        "dim": dim,
        "n_layers": n_layers,
        "n_heads": n_heads,
        "n_kv_heads": n_kv_heads,
        "batch": batch,
        "seq": seq,
        "itemsize": itemsize,
        "flops_per_step": train_flops_per_token(n_params) * batch * seq,
    }


# ----------------------------------------------- plan-cache comm accounting
def plan_comm_bytes(plan, policy, axis_sizes: Dict[str, int],
                    op=None) -> Dict[str, Any]:
    """Comm bytes of one gradient sync of a fusion plan
    (``ops/fusion.py``) under a wire policy: each bucket's format
    (``ops/wire.py``'s policy and ``resolve_format``) priced by the wire
    model, summed per fabric and per format.  ``axis_sizes`` is a layout,
    ``{"flat": n}`` or ``{"dcn": hosts, "ici": ranks per host}``."""
    from ..common.reduce_op import ReduceOp
    from ..ops import wire

    op = ReduceOp.AVERAGE if op is None else op
    pol = wire.get_policy(policy)
    total = 0.0
    per_fabric: Dict[str, float] = {}
    per_format: Dict[str, float] = {}
    for b in plan.buckets:
        fmt = wire.resolve_format(pol(b.nbytes, b.dtype, axis_sizes),
                                  b.dtype, axis_sizes, op)
        m = wire.modeled_wire_bytes(sum(b.sizes), b.dtype.itemsize, fmt,
                                    axis_sizes)
        total += m["bottleneck"]
        per_format[fmt] = per_format.get(fmt, 0.0) + m["bottleneck"]
        for fabric, v in m["per_fabric"].items():
            per_fabric[fabric] = per_fabric.get(fabric, 0.0) + v
    return {"bottleneck": int(total),
            "per_fabric": {k: int(v) for k, v in sorted(per_fabric.items())},
            "per_format": {k: int(v) for k, v in sorted(per_format.items())}}


# ---------------------------------------------------------- counted flops
ATTENTION_PRODUCTS = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}


def attention_flops(kind: str, B: int, S: int, H: int, D: int,
                    causal: bool) -> int:
    """Matrix-product FLOPs of one flash-attention call: the forward's two
    products (q.k, p.v), dq's three and dk/dv's four, each ``2 * D`` FLOPs
    a (q, k) pair and head; causal counts the pairs at or below the
    diagonal (``chip_smoke.py`` ``attention_cost``, the kernels' bound)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 2 * D * ATTENTION_PRODUCTS[kind] * pairs * B * H


class AttentionTally:
    """The attention leg of :func:`compiled_flops`, fed by
    ``ops/flash_attention.py``'s autograd Function while it is installed
    there: each call adds its :func:`attention_flops` and what the FLOP
    counter saw between :meth:`enter` and :meth:`leave`."""

    def __init__(self, counter):
        self.counter = counter
        self.flops = 0
        self.seen_inside = 0

    def enter(self) -> int:
        return self.counter.get_total_flops()

    def leave(self, kind: str, q_shape, causal: bool, before: int) -> None:
        B, S, H, D = q_shape
        self.flops += attention_flops(kind, B, S, H, D, causal)
        self.seen_inside += self.counter.get_total_flops() - before


def compiled_flops(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call of ``fn(*args, **kwargs)``: the aten operators'
    count under ``FlopCounterMode``, less what it saw inside the flash
    attention Function, plus that Function's own count (module docstring).
    ``fn`` runs once, for real (a train step updates its parameters).
    None when nothing was counted or the call raised: callers fall back to
    the 6N model (``train_flops_per_token``), as in the JAX package."""
    try:
        from torch.utils.flop_counter import FlopCounterMode

        from ..ops import flash_attention as _fa
        counter = FlopCounterMode(display=False)
        tally = AttentionTally(counter)
        prev, _fa.FLOP_TALLY = _fa.FLOP_TALLY, tally
        try:
            with counter:
                fn(*args, **kwargs)
        finally:
            _fa.FLOP_TALLY = prev
        flops = counter.get_total_flops() - tally.seen_inside + tally.flops
        return float(flops) if flops > 0 else None
    except Exception:
        return None
