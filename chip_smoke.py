#!/usr/bin/env python3
"""Drive horovod_tpu_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the CUDA kernels, from ``horovod_tpu_torch/csrc`` (nvcc), and
   a resource report of each kernel's bf16 D=64 instantiation: registers
   and spills (``-Xptxas -v``), static and dynamic shared memory, and
   resident blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
3. kernels: each flash-attention kernel against its plain PyTorch version
   on the card, at the training shape and at edges (D=128, non-causal,
   GQA groups 1 and 8, S not a multiple of 128, fp32), dq's and dk/dv's
   bitwise determinism, with kernel, plain and library times at the
   training shape (the library backward, SDPA's, covers dq and dk/dv
   together);
4. model: the ``mini`` Llama loss in bf16 with the kernels as ``attn_fn``
   against the same loss with the plain ``causal_attention``;
5. train: the ``1b`` Llama at full width and depth, data-parallel through
   ``DistributedOptimizer`` on a one-rank NCCL group, AdamW, flash attention
   and ``ce_chunks=8``: 2 warm-up, 5 timed and 1 profiled step, with the
   kernels' launch counts;
6. a ``{"kernels": [...]}`` JSON line, then the
   ``{"ok": true, "device": {...}}`` JSON line, last.

TF32 is off for matrix products and convolutions
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), so fp32 references are fp32.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
KERNEL_SOURCE = "horovod_tpu_torch/csrc/flash_attention.cu"
# kernel name -> the Pallas kernel it replaces (file:line of its definition)
REPLACES = {
    "flash_fwd": "horovod_tpu/ops/flash_attention.py:47",
    "flash_bwd_dq": "horovod_tpu/ops/flash_attention.py:113",
    "flash_bwd_dkv": "horovod_tpu/ops/flash_attention.py:163",
}
# kernel name -> its bf16 D=64 instantiation's mangled-name fragment
INSTANCES = {
    "flash_fwd": "fwd_mma_kernelILi64E",
    "flash_bwd_dq": "dq_mma_kernelILi64E",
    "flash_bwd_dkv": "dkv_mma_kernelILi64E",
}
# the CUDA kernels of flash_attention.cu, bf16 and fp32, by function name
ATTENTION_KERNELS = ("fwd_mma_kernel", "fwd_kernel", "dq_mma_kernel",
                     "dq_kernel", "dkv_mma_kernel", "dkv_kernel")
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
WARMUP_STEPS, TIMED_STEPS = 2, 5


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def median_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median of ``n`` timed launches, each between two CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[n // 2]


def attention_cost(kind: str, B, S, H, HK, D, causal, itemsize):
    """(matrix-product flops, bytes) that one call must do and move: each
    input read once, each output written once; causal counts only the
    (q, k) pairs at or below the diagonal."""
    pairs = S * (S + 1) // 2 if causal else S * S
    products = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}[kind]
    flops = 2 * D * products * pairs * B * H
    q_bytes = B * S * H * D * itemsize
    kv_bytes = B * S * HK * D * itemsize
    row_bytes = B * H * S * 4
    if kind == "flash_fwd":   # q, k, v -> out, lse
        nbytes = 2 * q_bytes + 2 * kv_bytes + row_bytes
    elif kind == "flash_bwd_dq":  # q, k, v, dO, lse, delta -> dq
        nbytes = 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes
    else:                     # q, k, v, dO, lse, delta -> dk, dv
        nbytes = 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes
    return flops, nbytes


def bound(kind, shape, causal, dtype):
    import torch
    itemsize = torch.empty((), dtype=dtype).element_size()
    flops, nbytes = attention_cost(kind, causal=causal, itemsize=itemsize,
                                   **shape)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def parse_ptxas(text: str) -> dict:
    """``{mangled kernel name: {"registers", "spill_bytes"}}`` from the
    ``ptxas info`` lines of ``nvcc -Xptxas -v``; spill bytes are the spill
    stores plus the spill loads."""
    out, entry, props = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {"registers": None, "spill_bytes": 0}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props in out:
            out[props]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in out:
            out[entry]["registers"] = int(m.group(1))
    return out


def phase_resources(_kernels, lib_path: str) -> None:
    """Registers, shared memory, spills and blocks per SM of each kernel's
    bf16 D=64 instantiation.  Each is designed for Hopper (register
    accumulators, pipelined loads), so it must not spill and must fit two
    or more blocks on an SM."""
    with open(lib_path + ".log") as f:
        ptxas = parse_ptxas(f.read())
    for name, fragment in INSTANCES.items():
        found = [v for k, v in ptxas.items() if fragment in k]
        require(len(found) == 1, f"ptxas output has {len(found)} entries "
                                 f"for {fragment}")
        info = found[0]
        res = _kernels.resources(name, 64, True)
        print(f"resources [{name} bf16 D=64]: {info['registers']} registers"
              f", shared memory {res['static_smem']} static + "
              f"{res['dynamic_smem']} dynamic bytes, spills "
              f"{info['spill_bytes']} bytes, {res['threads']} threads, "
              f"{res['blocks_per_sm']} blocks per SM", flush=True)
        require(info["spill_bytes"] == 0, f"{name} spills registers")
        require(res["blocks_per_sm"] >= 2,
                f"{name} fits {res['blocks_per_sm']} block per SM")


def kernel_kind(key: str) -> str:
    """The kind a profiled CUDA kernel's name books its time under."""
    if any(k in key for k in ATTENTION_KERNELS):
        return "flash attention"
    low = key.lower()
    if any(k in low for k in ("nvjet", "gemm", "xmma", "cutlass")):
        return "matrix products"
    return "nccl" if "nccl" in low else "other"


def tile_rel_err(got, ref, tile: int = 64) -> float:
    """Worst relative Frobenius error ``|got - ref| / |ref|`` over the
    blocks of ``tile`` sequence positions of one head of one batch entry
    (``[B, S, H, D]`` tensors).  Causal outputs shrink along the sequence,
    so a max error scaled by the largest value (near position 0) would hide
    a tile that is dropped or mis-masked further on; this does not."""
    B, S, H, D = ref.shape
    r = ref.float().reshape(B, S // tile, tile, H, D)
    d = got.float().reshape(B, S // tile, tile, H, D) - r
    return (d.norm(dim=(2, 4)) / r.norm(dim=(2, 4)).clamp_min(1e-30)
            ).max().item()


# Limits against the plain version on the same inputs (which rounds p and
# ds to bf16 as the kernels do): (max abs err / max|ref|, tile_rel_err).
BF16_LIMITS = (1e-2, 1e-2)
FP32_LIMITS = (1e-5, 1e-5)


def check_output(name: str, got, ref, dtype) -> tuple:
    """``(max abs err, tile_rel_err or None, within limits, limits)`` of one
    kernel output against its plain version.  lse is fp32 from fp32 scores
    on both sides, so it is held to an absolute limit."""
    import torch
    err = (got.float() - ref.float()).abs().max().item()
    if name == "lse":
        tol = 1e-4 if dtype == torch.float32 else 1e-3
        return err, None, err <= tol, f"atol {tol}"
    rel_max, rel_tile = BF16_LIMITS if dtype == torch.bfloat16 else FP32_LIMITS
    tile = tile_rel_err(got, ref)
    ok = err <= rel_max * ref.float().abs().max().item() and tile <= rel_tile
    return err, tile, ok, (f"max abs err <= {rel_max} * max|ref|, "
                           f"tile_rel_err <= {rel_tile}")


def phase_kernels(F, torch, card: str):
    """Each kernel against its plain version; returns the kernels' rows at
    the training shape."""
    cases = [  # (label, B, S, H, HK, D, dtype, causal)
        ("train", 4, 2048, 32, 8, 64, torch.bfloat16, True),
        ("D=128", 2, 1024, 16, 4, 128, torch.bfloat16, True),
        ("non-causal", 2, 1024, 32, 8, 64, torch.bfloat16, False),
        ("H=HK", 2, 1024, 8, 8, 64, torch.bfloat16, True),
        ("GQA group 8", 2, 1024, 32, 4, 64, torch.bfloat16, True),
        ("S=192", 2, 192, 8, 2, 64, torch.bfloat16, True),
        ("S=320", 1, 320, 8, 4, 64, torch.bfloat16, True),
        ("S=192 D=128 non-causal", 1, 192, 4, 2, 128, torch.bfloat16,
         False),
        ("fp32", 2, 256, 8, 2, 64, torch.float32, True),
        ("fp32 D=128 non-causal", 1, 256, 4, 2, 128, torch.float32, False),
    ]
    rows = {}
    for label, B, S, H, HK, D, dtype, causal in cases:
        gen = torch.Generator(device="cuda").manual_seed(0)
        mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
        q, k, v, do = mk(B, S, H, D), mk(B, S, HK, D), mk(B, S, HK, D), \
            mk(B, S, H, D)
        out, lse = F.flash_forward_cuda(q, k, v, causal)
        torch.cuda.synchronize()
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = F.flash_dq_cuda(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        dk, dv = F.flash_dkv_cuda(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        # references: the plain versions on the same tensors
        r_out, r_lse = F.attention_forward_plain(q, k, v, causal)
        r_dq = F.attention_dq_plain(q, k, v, do, lse, delta, causal)
        r_dk, r_dv = F.attention_dkv_plain(q, k, v, do, lse, delta, causal)
        errs, failed = {}, []
        readings = []
        for name, got, ref in (("out", out, r_out), ("lse", lse, r_lse),
                               ("dq", dq, r_dq), ("dk", dk, r_dk),
                               ("dv", dv, r_dv)):
            err, tile, ok, tol = check_output(name, got, ref, dtype)
            errs[name] = err
            scale = ref.float().abs().max().item()
            readings.append(f"{name} {err:.3g} ({err / scale:.2e} of max|ref|"
                            + (f", tile {tile:.2e})" if tile is not None
                               else ")"))
            if not ok:
                failed.append(f"{name} ({tol})")
        print(f"kernels [{label}] B={B} S={S} H={H} HK={HK} D={D} "
              f"{str(dtype)[6:]} causal={causal}: max abs err "
              + ", ".join(readings), flush=True)
        require(not failed, f"kernels disagree with their plain versions "
                            f"[{label}]: {', '.join(failed)}")
        if label != "train":
            continue
        dq2 = F.flash_dq_cuda(q, k, v, do, lse, delta, causal)
        dk2, dv2 = F.flash_dkv_cuda(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        require(torch.equal(dq, dq2),
                "dq differs between two launches on the same inputs")
        require(torch.equal(dk, dk2) and torch.equal(dv, dv2),
                "dk/dv differ between two launches on the same inputs")
        print("kernels [train]: dq and dk/dv bitwise equal across two "
              "launches", flush=True)
        del dq2, dk2, dv2
        shape = dict(B=B, S=S, H=H, HK=HK, D=D)
        calls = {
            "flash_fwd": (lambda: F.flash_forward_cuda(q, k, v, causal),
                          lambda: F.attention_forward_plain(q, k, v, causal),
                          max(errs["out"], errs["lse"])),
            "flash_bwd_dq": (
                lambda: F.flash_dq_cuda(q, k, v, do, lse, delta, causal),
                lambda: F.attention_dq_plain(q, k, v, do, lse, delta, causal),
                errs["dq"]),
            "flash_bwd_dkv": (
                lambda: F.flash_dkv_cuda(q, k, v, do, lse, delta, causal),
                lambda: F.attention_dkv_plain(q, k, v, do, lse, delta, causal),
                max(errs["dk"], errs["dv"])),
        }
        for name, (kernel, plain, err) in calls.items():
            b_ms, b_by = bound(name, shape, causal, dtype)
            rows[name] = {"name": name, "route": "cuda",
                          "source": KERNEL_SOURCE, "replaces": REPLACES[name],
                          "max_abs_err": err, "ms": median_ms(kernel),
                          "plain_ms": median_ms(plain), "bound_ms": b_ms,
                          "bound_by": b_by, "library_ms": None}
        # yardsticks only: one PyTorch call computing the forward, and the
        # same call's backward (dq, dk and dv together) on an output made
        # once, outside the timed region
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rows["flash_fwd"]["library_ms"] = median_ms(
            lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True))
        lib_out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
        dot = do.transpose(1, 2)
        dkv = rows["flash_bwd_dkv"]
        dkv["library_ms"] = median_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True))
        dkv["library_covers"] = "dq+dkv"
        dkv["kernel_sum_ms"] = rows["flash_bwd_dq"]["ms"] + dkv["ms"]
        for r in rows.values():
            lib = r["library_ms"]
            vs = (f"library {lib:.4f} ms, kernel/library {r['ms'] / lib:.3f}"
                  if lib is not None else "library none")
            if "library_covers" in r:
                vs = (f"library dq+dkv {lib:.4f} ms, kernels dq+dkv "
                      f"{r['kernel_sum_ms']:.4f} ms, kernel/library "
                      f"{r['kernel_sum_ms'] / lib:.3f}")
            print(f"kernel {r['name']} [{card}]: kernel_ms {r['ms']:.4f}, "
                  f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms"
                  f" ({r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of it), "
                  + vs, flush=True)
        del q, k, v, do, out, lse, delta, dq, dk, dv, qt, kt, vt, lib_out
    torch.cuda.empty_cache()
    return rows


def phase_model(torch, hvd, llama, L):
    """mini Llama loss with the kernels against the plain attention."""
    cfg = llama.CONFIGS["mini"]
    model = llama.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    ids = torch.randint(0, cfg.vocab, (2, 257), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    with torch.no_grad():
        flash = llama.loss_fn(model, ids, attn_fn=hvd.flash_attention).item()
        plain = llama.loss_fn(model, ids, attn_fn=L.causal_attention).item()
    print(f"model [mini bf16]: loss with kernels {flash:.6f}, with plain "
          f"attention {plain:.6f}", flush=True)
    require(math.isfinite(flash) and abs(flash - plain) <= 2e-2,
            f"mini loss with kernels {flash} vs plain {plain} (tol 2e-2)")


def phase_train(torch, np, hvd, llama, F):
    """The main path: 1b data-parallel training steps."""
    hvd.init()
    cfg = llama.CONFIGS["1b"]
    dev = torch.device("cuda", hvd.local_rank())
    model = llama.init(cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    require(n_params == llama.param_count(cfg),
            f"1b has {n_params} parameters, param_count says "
            f"{llama.param_count(cfg)}")
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    remat = False
    step = hvd.make_train_step(
        model, lambda m, ids: llama.loss_fn(m, ids, attn_fn=hvd.flash_attention,
                                            remat=remat, ce_chunks=8), opt)
    rng = np.random.RandomState(0)
    n_steps = WARMUP_STEPS + TIMED_STEPS + 1
    batches = [torch.from_numpy(rng.randint(
        0, cfg.vocab, (TRAIN_BATCH * hvd.size(), TRAIN_SEQ + 1),
        dtype=np.int32)).to(dev) for _ in range(n_steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    F.reset_launches()
    losses = [step(b) for b in batches[:WARMUP_STEPS]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[WARMUP_STEPS:WARMUP_STEPS + TIMED_STEPS]:
        losses.append(step(b))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        losses.append(step(batches[-1]))
        torch.cuda.synchronize()
    launches = dict(F.LAUNCHES)

    losses = [float(x) for x in losses]
    print("train [1b] losses " + " ".join(f"{x:.5f}" for x in losses),
          flush=True)
    require(all(math.isfinite(x) for x in losses), "non-finite loss")
    timed = losses[WARMUP_STEPS:WARMUP_STEPS + TIMED_STEPS]
    require(max(timed) - min(timed) > 0.0,
            "loss constant across steps: parameters not updating")
    per_step = {"flash_fwd": (2 if remat else 1) * cfg.n_layers,
                "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkv": cfg.n_layers}
    for name, n in per_step.items():
        require(launches[name] == n * n_steps,
                f"{name} launched {launches[name]} times in {n_steps} steps,"
                f" expected {n} per step")

    tokens = TIMED_STEPS * TRAIN_BATCH * hvd.size() * TRAIN_SEQ
    tok_s = tokens / dt
    mfu = 6 * n_params * tok_s / (PEAK_BF16_FLOPS * hvd.size())
    print(f"train [1b] {n_params} params, batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}, remat={remat}: step {dt / TIMED_STEPS * 1e3:.1f} ms, "
          f"{tok_s:.0f} tokens/s, MFU(6N) {mfu:.4f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print("train [1b] launches " + json.dumps(launches), flush=True)

    # where the profiled step's device time goes: CUDA kernels by kind
    from torch.autograd import DeviceType
    kinds = {"flash attention": 0.0, "matrix products": 0.0, "nccl": 0.0,
             "other": 0.0}
    top, attention = [], []
    for evt in prof.key_averages():
        # CUDA kernels only: record_function ranges (the optimizer's step)
        # also show on the device timeline, as user annotations
        if (evt.device_type != DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        us = evt.self_device_time_total
        kind = kernel_kind(evt.key)
        kinds[kind] += us
        top.append((us, evt.count, evt.key))
        if kind == "flash attention":
            fn = next(k for k in ATTENTION_KERNELS if k in evt.key)
            attention.append(f"{fn} {us / 1e3:.2f} ms x{evt.count}")
    busy = sum(kinds.values())
    step_ms = dt / TIMED_STEPS * 1e3
    require(busy > 0, "the profiled step shows no device time")
    print(f"train [1b] profiled step: device busy {busy / 1e3:.1f} ms "
          f"(timed step {step_ms:.1f} ms, idle share "
          f"{max(0.0, 1 - busy / 1e3 / step_ms):.3f}); by kind: "
          + ", ".join(f"{k} {v / 1e3:.1f} ms ({100 * v / busy:.1f}%)"
                      for k, v in kinds.items()), flush=True)
    print("train [1b] profiled step, flash attention by kernel: "
          + ", ".join(sorted(attention)), flush=True)
    for us, count, key in sorted(top, reverse=True)[:10]:
        print(f"  {us / 1e3:8.2f} ms x{count:<4} {key[:90]}", flush=True)
    hvd.shutdown()
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import layers as L, llama
    from horovod_tpu_torch.ops import _kernels, flash_attention as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; TF32 off for matmul and cuDNN", flush=True)
    card = smi.splitlines()[0]
    print(card, flush=True)

    t0 = time.perf_counter()
    lib = _kernels.build()
    print(f"build: {time.perf_counter() - t0:.1f} s ({lib})", flush=True)
    phase_resources(_kernels, lib)

    rows = phase_kernels(F, torch, card)
    phase_model(torch, hvd, llama, L)
    launches = phase_train(torch, np, hvd, llama, F)
    for row in rows.values():
        row["launches"] = launches[row["name"]]
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
