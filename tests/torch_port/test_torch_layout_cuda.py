"""The layout plane's collectives on the card (marker ``cuda``; skips
without two CUDA devices).  Imports no JAX: on the card's machine run it
with ``python -m pytest --noconftest -p no:cacheprovider
tests/torch_port/test_torch_layout_cuda.py``.

Two ranks, one card and one process each, over NCCL:

  * the GPipe shift's backward ordering: the tanh stack over two stages
    at ``n_micro`` 1, 2 and 4 (stage 0 never reads what it receives, and
    every tick's reverse shift must still pair up across the ranks),
    forward and each stage's gradients against the same stack run
    unpipelined on one card, within 1e-5;
  * Megatron's f/g pair: a ``TPLayer`` at tp=2 (each rank its slice)
    against ``llama.LlamaLayer`` holding the whole weights, in fp32 with
    TF32 off: the output, the input's gradient and each weight slice's
    gradient within 1e-5 of the full layer's, relative to its largest
    entry (the tp all-reduces add the halves in another order).
"""

import os
import socket
import time
import traceback

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

DIM, ROWS = 16, 8
MICRO = (1, 2, 4)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stages():
    rng = np.random.RandomState(0)
    ws = [(rng.randn(DIM, DIM) * 0.3).astype(np.float32) for _ in range(2)]
    bs = [(rng.randn(DIM) * 0.1).astype(np.float32) for _ in range(2)]
    x = rng.randn(ROWS, DIM).astype(np.float32)
    y = rng.randn(ROWS, DIM).astype(np.float32)
    return ws, bs, x, y


def _pipeline_case(rank, dev):
    from horovod_tpu_torch.parallel import pipeline as P
    ws, bs, x, y = _stages()
    out = {}
    for m in MICRO:
        p = {"w": torch.nn.Parameter(torch.from_numpy(ws[rank]).to(dev)),
             "b": torch.nn.Parameter(torch.from_numpy(bs[rank]).to(dev))}
        fn = P.make_pipeline_fn(lambda q, h: torch.tanh(h @ q["w"] + q["b"]),
                                n_micro=m)
        o = fn(p, torch.from_numpy(x).to(dev))
        loss = torch.mean((o - torch.from_numpy(y).to(dev)) ** 2)
        loss.backward()
        full = [{"w": torch.nn.Parameter(torch.from_numpy(w).to(dev)),
                 "b": torch.nn.Parameter(torch.from_numpy(b).to(dev))}
                for w, b in zip(ws, bs)]
        h = torch.from_numpy(x).to(dev)
        for q in full:
            h = torch.tanh(h @ q["w"] + q["b"])
        ref = torch.mean((h - torch.from_numpy(y).to(dev)) ** 2)
        ref.backward()
        out[m] = {
            "out": float((o - h).abs().max()),
            "grad": max(float((p[k].grad - full[rank][k].grad).abs().max())
                        for k in ("w", "b"))}
    return out


def _tp_case(rank, dev):
    import dataclasses
    import torch.distributed as dist
    from horovod_tpu_torch.models import layers as L, llama
    from horovod_tpu_torch.parallel import layout as Lay
    cfg = dataclasses.replace(llama.CONFIGS["tiny"], dtype=torch.float32)
    full = llama.LlamaLayer(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for p in full.parameters():
            p.normal_(0.0, 0.1, generator=gen)
    part = Lay.TPLayer(cfg, 2, dev)
    with torch.no_grad():
        for name, sub in part.named_children():
            for pname, p in sub.named_parameters():
                p.copy_(Lay._tp_slice(name, getattr(getattr(full, name),
                                                    pname), rank, 2))
    cos, sin = L.rope_freqs(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                            device=dev)
    x = torch.randn(2, 32, cfg.dim, generator=gen, device=dev)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya = part(xa, cos, sin, group=dist.group.WORLD)
    yb = full(xb, cos, sin)
    ya.square().sum().backward()
    yb.square().sum().backward()
    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())
    gap = {"out": rel(ya, yb), "dx": rel(xa.grad, xb.grad)}
    for name, sub in part.named_children():
        for pname, p in sub.named_parameters():
            want = Lay._tp_slice(name, getattr(getattr(full, name),
                                               pname).grad, rank, 2)
            gap[f"{name}.{pname}"] = rel(p.grad, want)
    return gap


def _run(rank, port, out_dir):
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE="2",
                      HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE="2",
                      HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                      HOROVOD_CONTROLLER="none")
    torch.backends.cuda.matmul.allow_tf32 = False
    import horovod_tpu_torch as hvd
    out = {}
    try:
        dev = hvd.init().device
        out["pipeline"] = _pipeline_case(rank, dev)
        out["tp"] = _tp_case(rank, dev)
        torch.cuda.synchronize()
    except Exception:
        out["_error"] = traceback.format_exc()
    np.save(os.path.join(out_dir, f"rank{rank}.npy"), out, allow_pickle=True)
    hvd.shutdown()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (one per rank)")
    import torch.multiprocessing as tmp
    out_dir = str(tmp_path_factory.mktemp("layout_cuda"))
    ctx = tmp.spawn(_run, args=(_free_port(), out_dir), nprocs=2,
                    join=False)
    deadline = time.monotonic() + 180
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail("the two ranks did not finish in 180 s")
    return [np.load(os.path.join(out_dir, f"rank{r}.npy"),
                    allow_pickle=True).item() for r in range(2)]


def test_no_rank_raised(ranks):
    for r in ranks:
        assert "_error" not in r, r.get("_error")


@pytest.mark.parametrize("m", MICRO)
def test_pipeline_backward_order_on_the_card(ranks, m):
    for r in ranks:
        got = r["pipeline"][m]
        assert got["out"] <= 1e-5 and got["grad"] <= 1e-5, got


def test_f_g_pair_on_the_card(ranks):
    for r in ranks:
        for name, gap in r["tp"].items():
            assert gap <= 1e-5, (name, gap)
