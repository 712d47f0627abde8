"""The eager API on a CUDA card, negotiated through the native controller
(``HOROVOD_CONTROLLER=tcp`` on a free port, one rank): every op on bf16
and fp32 tensors against its plain result, the stream ordering of the side
stream, and the hook-driven optimizer against a plain one.  Every case
carries the ``cuda`` marker and skips without a card.  The file imports no
JAX, so on a machine without it run

    python -m pytest --noconftest -p no:cacheprovider tests/torch_port/test_torch_eager_cuda.py
"""

import os

import pytest
import torch

import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch import runtime
from horovod_tpu_torch.ops import collectives as C, negotiated as N
from horovod_tpu_torch.torch import mpi_ops

from torch_port_ports import hold_ports

SPIN = int(2e8)  # GPU clock cycles of torch.cuda._sleep: tens of ms


def _warm(fn):
    """Run ``fn`` (the measured call and the read of its result) once and
    drain the card, so the measured call loads no kernel module, allocates
    nothing new and creates no communicator: each can synchronize the
    whole device and hide a missing stream wait.  (A process's first
    ``.sum()`` on the card loads its module lazily, and that load waited
    for the side stream's spin.)"""
    fn()
    torch.cuda.synchronize()


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    port = hold_ports(1).release()[0]
    os.environ.update(HOROVOD_CONTROLLER="tcp",
                      HOROVOD_CONTROLLER_PORT=str(port))
    try:
        hvd.init()
        yield torch.device("cuda", hvd.local_rank())
    finally:
        hvd.shutdown()
        for k in ("HOROVOD_CONTROLLER", "HOROVOD_CONTROLLER_PORT"):
            os.environ.pop(k, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_op_on_the_card(card, dtype):
    x = torch.randn(64, 33, device=card).to(dtype)
    for op in (hvd.Average, hvd.Sum, hvd.Min, hvd.Max, hvd.Product):
        out = hvd.allreduce(x, op=op)
        assert out.device == x.device and out.dtype == dtype
        torch.testing.assert_close(out, x)
    torch.testing.assert_close(
        hvd.allreduce(x, op=hvd.Sum, prescale_factor=2.0,
                      postscale_factor=0.5), x)
    y = x.clone()
    assert hvd.synchronize(hvd.allreduce_async_(y, op=hvd.Sum,
                                                prescale_factor=4.0)) is y
    torch.testing.assert_close(y, x * 4)
    outs = hvd.grouped_allreduce([x, x[:3].float()], op=hvd.Sum)
    torch.testing.assert_close(outs[0], x)
    torch.testing.assert_close(outs[1], x[:3].float())
    torch.testing.assert_close(hvd.allgather(x), x)
    torch.testing.assert_close(hvd.broadcast(x, 0), x)
    out, recv = hvd.alltoall(x, torch.tensor([64]))
    torch.testing.assert_close(out, x)
    assert recv.tolist() == [64]
    torch.testing.assert_close(hvd.reducescatter(x, op=hvd.Sum), x)
    hvd.barrier()
    assert mpi_ops.stats()["responses"] > 0


@pytest.mark.cuda
def test_side_stream_waits_for_the_callers_work(card):
    """The input is written on the caller's stream after a long spin; the
    collective must see the written value."""
    x = torch.zeros(1 << 20, device=card)

    def run():
        out = hvd.synchronize(hvd.allreduce_async_(x, op=hvd.Sum,
                                                   prescale_factor=2.0))
        return out.min().item(), out.max().item()
    _warm(run)
    torch.cuda._sleep(SPIN)
    x.fill_(3.0)
    assert run() == (6.0, 6.0)


def _unnegotiated_engine():
    """An engine on the runtime's device without a controller: each op
    runs at submission, on the same side stream."""
    eng = N.Engine(runtime.get())
    eng.core = None
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("api", ["negotiated", "negotiated in place",
                                 "un-negotiated"])
def test_synchronized_result_is_read_on_the_callers_stream(card, monkeypatch,
                                                           api):
    """The collective spins on the side stream before it reduces; after
    ``synchronize`` the caller's stream reads the result with no
    ``torch.cuda.synchronize()``, and it is complete.  The eager API into
    a new tensor and in place, and an engine without a controller."""
    x = torch.ones(1 << 20, device=card)
    if api == "negotiated":
        def run(scale):
            return hvd.synchronize(hvd.allreduce_async(
                x, op=hvd.Sum, postscale_factor=scale))
    elif api == "negotiated in place":
        def run(scale):
            x.fill_(1.0)
            return hvd.synchronize(hvd.allreduce_async_(
                x, op=hvd.Sum, postscale_factor=scale))
    else:
        eng = _unnegotiated_engine()

        def run(scale):
            return eng.wait(eng.submit(N.Op(
                eng.auto_name("allreduce"), "allreduce", [x],
                reduce_op=hvd.Sum, post=scale)))
    # the measured result may reuse the block of the warm-up or of an
    # earlier case, so each leaves a value the measured call does not expect
    _warm(lambda: run(3.0).sum().item())
    plain = C.allreduce_

    def slow(*args, **kwargs):
        torch.cuda._sleep(SPIN)  # on the side stream
        return plain(*args, **kwargs)
    monkeypatch.setattr(C, "allreduce_", slow)
    scale = {"negotiated": 5.0, "negotiated in place": 7.0,
             "un-negotiated": 9.0}[api]
    assert run(scale).sum().item() == scale * (1 << 20)


@pytest.mark.cuda
def test_hook_optimizer_on_the_card(card):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.Tanh(),
                                torch.nn.Linear(64, 8)).to(card)
    ref = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.Tanh(),
                              torch.nn.Linear(64, 8)).to(card)
    ref.load_state_dict(model.state_dict())
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-2),
        named_parameters=model.named_parameters(), bucket_bytes=4096)
    plain = torch.optim.AdamW(ref.parameters(), lr=1e-2)
    gen = torch.Generator(device=card).manual_seed(1)
    before = mpi_ops.stats()["names"]
    for _ in range(3):
        xb = torch.randn(16, 32, device=card, generator=gen)
        for m, o in ((model, opt), (ref, plain)):
            o.zero_grad()
            m(xb).square().mean().backward()
            o.step()
    for a, b in zip(model.parameters(), ref.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert mpi_ops.stats()["names"] - before >= 3
