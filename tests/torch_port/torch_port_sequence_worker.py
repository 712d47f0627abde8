"""One gloo rank of sequence parallelism's four-rank run
(tests/torch_port/test_torch_sequence.py), started with
torch.multiprocessing.  Imports torch and horovod_tpu_torch only, never
JAX.

Each rank holds its shard of the sequence (rank r the positions ``[r *
S/4, (r + 1) * S/4)``, over the world; ``pair`` cases over the groups
{0, 1} and {2, 3}, rank r at position r % 2 of its pair) and records its
outputs and gradients under ``out[name]``, saved to
``<out_dir>/rank<r>.npy``; a case that raised is recorded under
``_<name>`` with its traceback.  The flash ring's per-block calls of the
attention passes are counted, to hold the three-way block split to ``r +
1`` blocks on rank r."""

import dataclasses
import os
import traceback

import numpy as np

SIZE = 4
QKV = dict(B=2, S=32, H=8, D=16)  # tests/test_sequence_parallel.py's _qkv
LLAMA_ROWS, LLAMA_SEQ = 2, 64


def qkv(Hkv=None, seed=0, B=2, S=32, H=8, D=16):
    rng = np.random.RandomState(seed)
    Hkv = Hkv or H
    return (rng.randn(B, S, H, D).astype(np.float32),
            rng.randn(B, S, Hkv, D).astype(np.float32),
            rng.randn(B, S, Hkv, D).astype(np.float32))


def llama_ids(vocab):
    return np.random.RandomState(0).randint(
        0, vocab, (LLAMA_ROWS, LLAMA_SEQ + 1)).astype(np.int64)


def _np(t):
    return t.detach().float().numpy().copy()


def _shard(a, idx, n):
    s = a.shape[1] // n
    return np.ascontiguousarray(a[:, idx * s:(idx + 1) * s])


def _attn_case(torch, S, fn, arrays, idx, n, grads=False):
    ts = [torch.from_numpy(_shard(a, idx, n)).requires_grad_(grads)
          for a in arrays]
    out = fn(*ts)
    res = {"out": _np(out)}
    if grads:
        (out ** 2).sum().backward()
        res["grads"] = [_np(t.grad) for t in ts]
    return res


def _counted(F, fn):
    """Run ``fn`` counting the calls of the three attention passes."""
    calls = {"forward": 0, "dq": 0, "dkv": 0}
    saved = (F.attention_forward, F.attention_dq, F.attention_dkv)

    def wrap(key, f):
        def g(*a, **kw):
            calls[key] += 1
            return f(*a, **kw)
        return g
    F.attention_forward = wrap("forward", saved[0])
    F.attention_dq = wrap("dq", saved[1])
    F.attention_dkv = wrap("dkv", saved[2])
    try:
        res = fn()
    finally:
        F.attention_forward, F.attention_dq, F.attention_dkv = saved
    res["calls"] = calls
    return res


def _llama_case(torch, hvd, tree, idx, n, group):
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import sequence as SP
    cfg = dataclasses.replace(llama.CONFIGS["tiny"], max_seq=128)
    model = llama.params_from_jax(tree, cfg, device="cpu")
    ids = llama_ids(cfg.vocab)
    inp = torch.from_numpy(_shard(ids[:, :-1], idx, n))
    tgt = torch.from_numpy(_shard(ids[:, 1:], idx, n))
    attn = SP.make_ring_attn_fn(group=group, kernel="flash")
    with torch.no_grad():
        logits = model(inp, attn_fn=attn, pos_offset=idx * inp.shape[1])
    loss = SP.sequence_loss_fn(model, inp, tgt, attn_fn=attn, group=group,
                               ce_chunks=2)
    loss.backward()
    hvd.sync_gradients(model.parameters(), op=hvd.Sum)
    return {"logits": _np(logits), "loss": float(loss),
            "grads": {name: _np(p.grad)
                      for name, p in model.named_parameters()}}


def run(rank, port, out_dir):
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(SIZE),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(SIZE),
                      HOROVOD_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                      HOROVOD_CONTROLLER="none")
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import flash_attention as F
    from horovod_tpu_torch.parallel import sequence as SP
    hvd.init(device="cpu")
    pair = [dist.new_group([0, 1]), dist.new_group([2, 3])][rank // 2]
    tree = np.load(os.path.join(out_dir, "llama.npy"),
                   allow_pickle=True).item()
    S = QKV["S"]

    def ring(causal, kernel="xla", group=None):
        return lambda q, k, v: SP.ring_attention(q, k, v, group=group,
                                                 causal=causal, kernel=kernel)
    cases = [
        ("ring causal", lambda: _attn_case(torch, S, ring(True), qkv(),
                                           rank, SIZE, grads=True)),
        ("ring non-causal", lambda: _attn_case(torch, S, ring(False), qkv(),
                                               rank, SIZE)),
        ("ring gqa", lambda: _attn_case(torch, S, ring(True), qkv(Hkv=4),
                                        rank, SIZE)),
        ("ring long", lambda: _attn_case(
            torch, 64, ring(True), qkv(seed=3, B=1, S=64, H=4, D=8), rank,
            SIZE)),
        ("ulysses causal", lambda: _attn_case(
            torch, S, lambda q, k, v: SP.ulysses_attention(q, k, v),
            qkv(), rank, SIZE, grads=True)),
        ("ulysses non-causal", lambda: _attn_case(
            torch, S, lambda q, k, v: SP.ulysses_attention(q, k, v,
                                                           causal=False),
            qkv(), rank, SIZE)),
    ]
    for hkv in (8, 4):
        cases.append((f"flash fwd Hkv={hkv}", lambda hkv=hkv: _counted(
            F, lambda: _attn_case(torch, S, ring(True, "flash"),
                                  qkv(Hkv=hkv, seed=3), rank, SIZE))))
        cases.append((f"flash grads Hkv={hkv}", lambda hkv=hkv: _counted(
            F, lambda: _attn_case(torch, S, ring(True, "flash"),
                                  qkv(Hkv=hkv, seed=5), rank, SIZE,
                                  grads=True))))
        cases.append((f"pair flash grads Hkv={hkv}", lambda hkv=hkv: _counted(
            F, lambda: _attn_case(torch, S, ring(True, "flash", pair),
                                  qkv(Hkv=hkv, seed=5), rank % 2, 2,
                                  grads=True))))
    cases.append(("llama", lambda: _llama_case(torch, hvd, tree, rank, SIZE,
                                               None)))
    out = {}
    for name, fn in cases:
        try:
            out[name] = fn()
        except Exception:
            out["_" + name] = traceback.format_exc()
    q, k, v = (torch.from_numpy(_shard(a, rank, SIZE)) for a in qkv(seed=4))
    try:
        SP.ring_attention(q, k, v, causal=False, kernel="flash")
    except NotImplementedError as e:
        out["flash non-causal"] = str(e)
    try:
        SP.ulysses_attention(*(torch.zeros(1, 8, 6, 16) for _ in range(3)))
    except ValueError as e:
        out["ulysses heads"] = str(e)
    np.save(os.path.join(out_dir, f"rank{rank}.npy"), out, allow_pickle=True)
    hvd.shutdown()
