"""The port's own copy of the native controller against the JAX package's:
the same submissions on a four-rank loopback hub give the same responses
in the same order, with the same fused names; plus the port's builder,
binding, knobs and the signature dialect."""

import os
import socket

import numpy as np
import pytest
import torch

from horovod_tpu.common import basics as JB
from horovod_tpu.ops import negotiated as JN

import horovod_tpu_torch as hvd
import horovod_tpu_torch.torch as ht
from horovod_tpu_torch.common import basics as TB
from horovod_tpu_torch.common.exceptions import DuplicateTensorNameError
from horovod_tpu_torch.ops import _native, negotiated as TN

RANKS = 4
# long cycles make a round that a cycle boundary splits rare; such a round
# is detected (``_cycles_taken``) and the whole drive is run again on both
# libraries, so the batching compared does not depend on timing
CYCLE_MS = 250.0
FUSION_BYTES = 256
ATTEMPTS = 10


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _round(rng, names_sigs):
    """Every rank's submissions of one round, each rank in its own order."""
    return {r: [names_sigs[i] for i in rng.permutation(len(names_sigs))]
            for r in range(RANKS)}


def _script():
    rng = np.random.RandomState(0)
    f32 = [(f"grad.{i}", f"f32:{5 * (i + 1)}:allreduce:0", 0, 20 * (i + 1))
           for i in range(8)]
    mixed = [("m.a", "f32:4x4:allreduce:1", 0, 64),
             ("m.b", "bf16:8:allreduce:0", 0, 16),
             ("m.c", "f32:3:allreduce:0", 0, 12),
             ("m.d", "bf16:2x3:allreduce:0", 0, 12),
             ("m.bc0", "f32:6:broadcast:1", 2, 24),
             ("m.bc1", "f32:2:broadcast:1", 2, 8),
             ("m.ag", "i64:1:allgather:", 1, 8),
             ("m.group", "f32:2x2:grouped_allreduce:1+f32:3:grouped_allreduce"
                         ":1", 0, 28)]
    late = [(f"late.{i}", f"f32:{i + 2}:allreduce:1", 0, 4 * (i + 2))
            for i in range(4)]
    rounds = [_round(rng, f32), _round(rng, mixed)]
    joined = _round(rng, late)
    joined[2] = ["JOIN"]  # rank 2 is out of data; it answers with zeros
    rounds.append(joined)
    rounds.append({r: ["JOIN"] for r in range(RANKS) if r != 2})
    return rounds


def _cycles_taken(core):
    """How many controller cycles of ``core`` took submissions or made
    responses since the last call: each records one ``cycle.negotiate``
    span (and a locked epoch's cycles a ``cycle.bypass`` span instead)."""
    return sum(1 for _, phase, _, name, _ in core.trace_drain()["events"]
               if phase == "B" and name in ("cycle.negotiate",
                                            "cycle.bypass"))


def _drive(basics):
    """Run the script on ``basics``' library; every rank's responses as
    ``(type, op, total_bytes, names, sigs)``, and whether every round landed
    in one cycle: one cycle on every rank that took all its submissions
    and made all the round's responses.  A round split by a cycle boundary
    (a rank's submissions taken over two cycles, or ranks taking theirs in
    different cycles) shows as a second such cycle on some rank."""
    hub = basics.LoopbackHub(RANKS)
    cores = [basics.CoordinationCore.loopback(
        hub, r, cycle_ms=CYCLE_MS, fusion_bytes=FUSION_BYTES)
        for r in range(RANKS)]
    for c in cores:
        c.trace_enable()
    logs = [[] for _ in range(RANKS)]
    one_cycle = True
    try:
        for rnd in _script():
            expected = {item[0] for items in rnd.values() for item in items
                        if item != "JOIN"}
            for r in range(RANKS):
                for item in rnd.get(r, []):
                    if item == "JOIN":
                        cores[r].join()
                    else:
                        cores[r].submit(*item)
            for r in range(RANKS):
                seen = set()
                while True:
                    resp = cores[r].wait(10.0)
                    assert resp is not None, f"rank {r} got no response"
                    logs[r].append((resp.type, resp.op, resp.total_bytes,
                                    tuple(resp.names), tuple(resp.sigs)))
                    seen |= set(resp.names)
                    if resp.type == "JOIN_DONE" or (expected and
                                                    seen >= expected):
                        break
            one_cycle &= all(_cycles_taken(c) == 1 for c in cores)
    finally:
        for c in cores:
            c.shutdown()
        for c in cores:
            c.close()
        hub.close()
    return logs, one_cycle


@pytest.fixture(scope="module")
def both_logs():
    for _ in range(ATTEMPTS):
        (jax_logs, jax_ok), (port_logs, port_ok) = _drive(JB), _drive(TB)
        if jax_ok and port_ok:
            return jax_logs, port_logs
    pytest.fail(f"no drive of {ATTEMPTS} on both libraries had every round "
                "in one controller cycle")


def test_port_core_gives_the_jax_cores_responses(both_logs):
    jax_logs, port_logs = both_logs
    assert port_logs == jax_logs


def test_every_rank_gets_one_response_sequence(both_logs):
    _, logs = both_logs
    for r in range(1, RANKS):
        assert logs[r] == logs[0]


def test_responses_fuse_under_threshold_and_split_by_op_and_dtype(both_logs):
    _, logs = both_logs
    ok = [e for e in logs[0] if e[0] == "OK"]
    assert all(e[2] <= FUSION_BYTES or len(e[3]) == 1 for e in ok)
    assert any(len(e[3]) > 1 for e in ok), "nothing was fused"
    for e in ok:
        dtypes = {s.split(":")[0] for s in e[4]}
        assert len(dtypes) == 1, e
    names = [n for e in ok for n in e[3]]
    assert len(names) == len(set(names)) == 8 + 8 + 4
    assert logs[0][-1][0] == "JOIN_DONE"
    assert logs[0][-1][2] == 3  # the last rank to join


def test_build_goes_to_the_ports_own_directory():
    lib = TB.load_library()
    path = os.path.realpath(lib._name)
    assert path == os.path.realpath(_native.library_path())
    assert os.path.dirname(path) == os.path.realpath(_native.build_dir())
    assert os.path.basename(path).startswith("libhvd_torch_core-")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    assert not path.startswith(os.path.join(repo, "csrc") + os.sep)
    assert _native.SOURCE_DIR == os.path.join(repo, "horovod_tpu_torch",
                                              "csrc", "core")
    assert sorted(_native.SOURCES + _native.HEADERS) == sorted(
        n for n in os.listdir(_native.SOURCE_DIR)
        if n.endswith((".cc", ".h")))


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    for name in _native.SOURCES + _native.HEADERS:
        with open(os.path.join(_native.SOURCE_DIR, name)) as f:
            (tmp_path / name).write_text(f.read())
    monkeypatch.setattr(_native, "SOURCE_DIR", str(tmp_path))
    before = _native.library_path()
    assert before == TB.load_library()._name
    (tmp_path / "core.cc").write_text((tmp_path / "core.cc").read_text()
                                      + "\n// edited\n")
    assert _native.library_path() != before


def test_binding_refuses_duplicates_and_delimiters():
    """Rank 1 holds "dup" back, so rank 0's first submission stays in
    flight however long the second one takes to come."""
    hub = TB.LoopbackHub(2)
    cores = [TB.CoordinationCore.loopback(hub, r, cycle_ms=1000.0)
             for r in range(2)]
    core = cores[0]
    try:
        core.submit("dup", "f32:1:allreduce:0")
        with pytest.raises(DuplicateTensorNameError):
            core.submit("dup", "f32:1:allreduce:0")
        with pytest.raises(ValueError, match="delimiter"):
            core.submit("a,b", "f32:1:allreduce:0")
        cores[1].submit("dup", "f32:1:allreduce:0")
        assert core.wait(5.0).names == ["dup"]
        assert cores[1].wait(5.0).names == ["dup"]
        assert core.rank() == 0 and core.size() == 2 and core.healthy()
    finally:
        for c in cores:
            c.shutdown()
        for c in cores:
            c.close()
        hub.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64, torch.uint8, torch.float16])
def test_signature_dialect_matches_jax(dtype):
    np_dtype = {torch.float32: np.float32, torch.int64: np.int64,
                torch.uint8: np.uint8, torch.float16: np.float16}
    t = torch.zeros((2, 3), dtype=dtype)
    sig = TN.signature(t, "allreduce", "0")
    if dtype in np_dtype:
        assert sig == JN.np_signature(np.zeros((2, 3), np_dtype[dtype]),
                                      "allreduce", "0")
    else:
        assert sig == "bf16:2x3:allreduce:0"
    (z,) = TN.zeros_from_signature(sig, torch.device("cpu"))
    assert z.dtype == dtype and z.shape == (2, 3) and not z.any()
    ref = JN.np_zeros_from_signature(sig)
    assert ref.shape == tuple(z.shape)


def test_signature_rows_free_for_ragged_kinds():
    t = torch.zeros(5, 2)
    assert TN.signature(t, "allgather_ragged") == "f32:0x2:allgather_ragged:"
    assert TN.signature(t, "alltoall") == "f32:0x2:alltoall:"
    assert TN.signature(t, "allgather") == "f32:5x2:allgather:"
    group = TN.Op("g", "grouped_allreduce", [t, torch.zeros(3)],
                  reduce_op=hvd.Sum)
    assert group.sig == ("f32:5x2:grouped_allreduce:1+"
                         "f32:3:grouped_allreduce:1")
    assert [tuple(z.shape) for z in TN.zeros_from_signature(
        group.sig, torch.device("cpu"))] == [(5, 2), (3,)]


@pytest.mark.parametrize("knob", ["HOROVOD_FLIGHT_RECORD"])
def test_unported_controller_knobs_raise(monkeypatch, knob):
    monkeypatch.setenv(knob, "1")
    with pytest.raises(NotImplementedError, match="queue 1 item 4.3"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


@pytest.mark.parametrize("knob", ["HOROVOD_AUTOTUNE", "HOROVOD_TIMELINE"])
def test_measure_knobs_start_their_plane(monkeypatch, tmp_path, knob):
    """HOROVOD_AUTOTUNE and HOROVOD_TIMELINE start their planes at init:
    the autotuner at the knob's threshold, the timeline writing the
    negotiated ops' lifecycle."""
    monkeypatch.setenv("HOROVOD_CONTROLLER", "tcp")
    monkeypatch.setenv("HOROVOD_CONTROLLER_PORT", str(_free_port()))
    path = tmp_path / "tl.json"
    monkeypatch.setenv(knob, "1" if knob == "HOROVOD_AUTOTUNE" else str(path))
    rt = hvd.init(device="cpu")
    try:
        if knob == "HOROVOD_AUTOTUNE":
            assert hvd.autotuner() is rt.autotuner is not None
            assert rt.fusion_threshold() == \
                rt.knobs["HOROVOD_FUSION_THRESHOLD"]
            assert rt.core.autotune_state() is not None
            assert rt.timeline is None
        else:
            assert rt.timeline is not None and hvd.autotuner() is None
        ht.allreduce(torch.ones(4), name="plane.x")
    finally:
        hvd.shutdown()
    if knob == "HOROVOD_TIMELINE":
        from horovod_tpu_torch.utils.timeline import load_trace_events
        names = [e["name"] for e in load_trace_events(str(path))
                 if e.get("ph") != "M"]
        for phase in ("NEGOTIATE", "QUEUE", "EXEC"):
            assert phase in names


def test_controller_modes(monkeypatch):
    monkeypatch.setenv("HOROVOD_CONTROLLER", "mpi")
    with pytest.raises(ValueError, match="HOROVOD_CONTROLLER"):
        hvd.init(device="cpu")
    monkeypatch.setenv("HOROVOD_CONTROLLER", "auto")
    rt = hvd.init(device="cpu")
    try:
        assert rt.ensure_core() is None  # one process: no negotiation
    finally:
        hvd.shutdown()
