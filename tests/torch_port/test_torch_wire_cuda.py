"""The wire and overlap planes on a CUDA card, one rank: the codec on the
card bitwise equal to the CPU's, and the stream order of the microbatch
pipeline (``ops/overlap.py``): the sync reads a copy of the gradients
taken on the caller's stream after their backward, the side stream waits
for that copy, and the step waits for the sync.  Each of the three fails
with its wait or its copy deleted.  Every case carries the
``cuda`` marker and skips without a card.  The file imports no JAX, so on
a machine without it run

    python -m pytest --noconftest -p no:cacheprovider tests/torch_port/test_torch_wire_cuda.py
"""

import itertools

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import collectives as C, quantized, spmd, wire
from horovod_tpu_torch.ops.compression import Compression

SPIN = int(2e8)  # GPU clock cycles of torch.cuda._sleep: tens of ms
N = 1 << 20
# every cycle of the process takes values no earlier cycle wrote: a read
# that runs ahead of its write finds a reused block's stale values, and
# those must not be the ones expected (a block the allocator hands back
# can hold an earlier cycle's exact values)
_VALUES = itertools.count(1)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        hvd.init()
        yield torch.device("cuda", hvd.local_rank())
    finally:
        hvd.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.0, 1e-3, 1.0, 1e4])
def test_codec_on_the_card_is_the_cpus(card, scale):
    gen = torch.Generator(device=card).manual_seed(int(scale) + 1)
    x = torch.randn(N + 7, generator=gen, device=card) * scale
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        xd, xh = x.to(dtype), x.to(dtype).cpu()
        pairs = [(quantized.int8_roundtrip(xd), quantized.int8_roundtrip(xh))]
        if dtype == torch.float32:
            pairs += list(zip(quantized._quantize(xd),
                              quantized._quantize(xh)))
        for fmt in wire.FORMAT_NAMES:
            pairs.append((wire.local_error(xd, fmt), wire.local_error(xh, fmt)))
        for fmt in ("bf16", "fp16"):
            comp = Compression.by_name(fmt)
            pairs.append((comp.compress(xd)[0], comp.compress(xh)[0]))
        for got, want in pairs:
            assert torch.equal(got.cpu().reshape(-1).view(torch.uint8),
                               want.reshape(-1).view(torch.uint8))


def _spin(stream, cycles=SPIN):
    with torch.cuda.stream(stream):
        torch.cuda._sleep(cycles)


def _cycle(card, depth, spin_main=False, spin_side=False, slow_sync=False,
           overwrite=False):
    """One k=2 cycle of SGD(lr=1) from w = 4v with the constant gradients
    v + 1 and v + 3, v new to this cycle (the second written into the
    first's buffer, as a backward accumulating into ``.grad`` does), and a
    postscale of 2, so the sync changes what it reads: w must end at
    exactly 4v - 2(v + 2).  Returns w's max and min and that value.

    The synced result lands in the copy the sync read, so a read and a
    write of the side stream must both be placed: ``spin_main`` delays
    the caller's stream before the first step (a sync that does not wait
    for the copy reads it unwritten); ``slow_sync`` spins the side stream
    inside each sync, between its read and its write (the copy's stale
    read then lands after the caller's write, and a step that does not
    wait for the sync reads it unscaled); ``spin_side`` delays the side
    stream before the first sync and ``overwrite`` writes ``.grad`` right
    after ``step()`` (a sync that reads ``.grad`` instead of a copy sees
    the overwrite)."""
    v = 16.0 * next(_VALUES)
    w = torch.nn.Parameter(torch.full((N,), 4.0 * v, device=card))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                   backward_passes_per_step=2,
                                   wire_policy="int8_ring",
                                   error_feedback=True, postscale_factor=2.0,
                                   overlap=True, overlap_depth=depth)
    side = C.side_stream(card)
    w.grad = torch.full((N,), v + 1.0, device=card)
    if spin_main:  # half the sync's spin: the caller writes first
        _spin(torch.cuda.current_stream(card), SPIN // 2)
    if spin_side:
        _spin(side)
    real = spmd.allreduce

    def slow(*args, **kwargs):
        torch.cuda._sleep(SPIN)  # on the side stream
        return real(*args, **kwargs)
    spmd.allreduce = slow if slow_sync else real
    try:
        opt.step()
        if overwrite:
            w.grad.fill_(-1.0)  # lands before the delayed sync reads
        w.grad.fill_(v + 3.0)
        opt.step()
    finally:
        spmd.allreduce = real
    return (w.detach().max().item(), w.detach().min().item(),
            4.0 * v - 2.0 * (v + 2.0))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("case", [
    dict(spin_main=True, slow_sync=True), dict(slow_sync=True),
    dict(spin_side=True, overwrite=True)],
    ids=["caller-late", "sync-late", "overwrite-after-step"])
def test_pipeline_stream_order(card, depth, case):
    """Warmed up first: a lazy kernel load, a first collective or a new
    allocation synchronizes the card and would hide a missing wait."""
    for _ in range(2):
        high, low, want = _cycle(card, depth, **case)
        assert high == low == want
        torch.cuda.synchronize()
