"""The input pipeline's and the ZeRO chain's stream order on a CUDA card:
``prefetch`` (``data/loader.py``) copies each batch on a copy stream, so
the consumer's stream must wait on the copy's event, and the batch must be
marked as used on the consumer's stream (``record_stream``) so that the
allocator does not give its memory to the next copy while the consumer's
work on it is queued; and the level-3 step of ``parallel/zero.py``
unpacks a gathered bucket only after waiting on its gather.  Each case
also runs a mutant with the wait or the mark taken out and requires the
check to catch it.  Every case carries the ``cuda`` marker and skips
without a card.  The file imports no JAX, so on a machine without it run

    python -m pytest --noconftest -p no:cacheprovider tests/torch_port/test_torch_zero_cuda.py
"""

import itertools

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.data import CudaTransfer, prefetch
from horovod_tpu_torch.parallel import zero as Z

SPIN = int(2e8)  # GPU clock cycles of torch.cuda._sleep: tens of ms
N = 1 << 20
_VALUES = itertools.count(1)  # every batch of the process is new


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        hvd.init()
        yield torch.device("cuda", hvd.local_rank())
    finally:
        hvd.shutdown()


class _NoWait(CudaTransfer):
    def handoff(self, staged):
        consumer = torch.cuda.current_stream(self.device)
        for t in staged.batch:
            t.record_stream(consumer)
        return staged.batch


class _NoRecord(CudaTransfer):
    def handoff(self, staged):
        torch.cuda.current_stream(self.device).wait_event(staged.event)
        return staged.batch


def _late_copy(card, cls):
    """The copy stream is spun before each copy; the consumer reads each
    batch at once.  True when every read saw its batch."""
    side = torch.cuda.Stream(card)
    src = [next(_VALUES) for _ in range(4)]

    def batches():
        for v in src:
            with torch.cuda.stream(side):  # this batch's copy starts late
                torch.cuda._sleep(SPIN)
            yield (np.full(N, float(v), np.float32),)
    reads = [b.clone() for (b,) in prefetch(batches(), depth=2,
                                            transfer=cls(card, stream=side))]
    torch.cuda.synchronize()
    return all(bool((r == v).all()) for r, v in zip(reads, src))


def _late_read(card, cls):
    """The consumer's stream is spun before each read and the batch dropped
    at once; the next batch's copy runs while the read waits.  True when
    every read saw its batch."""
    side = torch.cuda.Stream(card)
    outs = []
    src = [next(_VALUES) for _ in range(4)]
    it = ((np.full(N, float(v), np.float32),) for v in src)
    for (b,) in prefetch(it, depth=1, transfer=cls(card, stream=side)):
        torch.cuda._sleep(SPIN)
        outs.append(b * 1.0)
        del b
    torch.cuda.synchronize()
    return all(bool((o == v).all()) for o, v in zip(outs, src))


@pytest.mark.cuda
def test_prefetch_consumer_waits_for_the_copy(card):
    """Warmed up first: a new allocation (device or pinned) or a lazy
    kernel load synchronizes the card and would hide a missing wait."""
    for _ in range(2):
        _late_copy(card, CudaTransfer)
    assert _late_copy(card, CudaTransfer)
    assert not _late_copy(card, _NoWait), "the check misses a missing wait"


@pytest.mark.cuda
def test_prefetch_marks_the_batch_on_the_consumer_stream(card):
    for _ in range(2):
        _late_read(card, CudaTransfer)
        _late_read(card, _NoRecord)
    assert _late_read(card, CudaTransfer)
    assert not _late_read(card, _NoRecord), \
        "the check misses a missing record_stream"


@pytest.mark.cuda
def test_prefetch_default_batches_equal_the_host(card):
    host = [np.random.RandomState(i).randint(0, 1000, (4, 33))
            for i in range(5)]
    got = [b for (b,) in prefetch(((h,) for h in host))]
    assert all(g.device == card for g in got)
    for g, h in zip(got, host):
        assert torch.equal(g.cpu(), torch.from_numpy(h))


def _slow_gather(side, wait):
    """A one-rank all-gather on ``side``, spun before its copy; its
    handle's ``wait`` makes the caller's stream wait (or, the mutant,
    nothing)."""
    def ag(out, inp, group=None, async_op=False):
        main = torch.cuda.current_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            torch.cuda._sleep(SPIN)
            out.copy_(inp)
            event = torch.cuda.Event()
            event.record(side)
        out.record_stream(side)

        class Handle:
            def wait(self):
                if wait:
                    main.wait_event(event)
        handle = Handle()
        if async_op:
            return handle
        handle.wait()
    return ag


def _level3_loss(card, monkeypatch, wait):
    """One level-3 step at lr 0 through the slow gather: its loss against
    the loss of the model it was sharded from.  Each call's weights are
    new, so a buffer read before its gather wrote it holds no earlier
    call's values."""
    gen = torch.Generator(device=card).manual_seed(next(_VALUES))
    model = torch.nn.Sequential(torch.nn.Linear(256, 256),
                                torch.nn.Linear(256, 1)).to(card)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=card))
    x = torch.randn(64, 256, generator=gen, device=card)
    loss_fn = lambda m, x: m(x).pow(2).mean()  # noqa: E731
    with torch.no_grad():
        want = loss_fn(model, x).item()
    state = Z.init_zero_state(torch.optim.SGD, model, zero_level=3,
                              fusion_threshold_bytes=1 << 16, lr=0.0)
    step = Z.make_zero_train_step(model, loss_fn, state, zero_level=3,
                                  ag_prefetch=2,
                                  fusion_threshold_bytes=1 << 16)
    monkeypatch.setattr(Z.dist, "all_gather_into_tensor",
                        _slow_gather(torch.cuda.Stream(card), wait))
    # the released parameters' blocks still hold their values, and a
    # gather's buffer may be one of them: fill every block of those sizes
    # with NaN first, so a read ahead of the gather cannot find them
    junk = [torch.full((p.numel(),), float("nan"), device=card)
            for p in model.parameters() for _ in range(4)]
    del junk
    try:
        got = step(x).item()
    finally:
        monkeypatch.undo()
    return got, want


@pytest.mark.cuda
def test_level3_unpacks_a_bucket_only_after_its_gather(card, monkeypatch):
    for _ in range(2):
        _level3_loss(card, monkeypatch, True)
    got, want = _level3_loss(card, monkeypatch, True)
    assert got == pytest.approx(want, rel=1e-5)
    got, want = _level3_loss(card, monkeypatch, False)
    assert not got == pytest.approx(want, rel=1e-5), \
        "the check misses an unpack before the gather's wait"
