"""The port's elastic driver side (``horovod_tpu_torch/elastic/driver.py``,
``discovery.py``, ``worker.py``) and its launcher wiring, against the JAX
package's where both have the function (the cases of tests/test_elastic.py
:330-540): the host manager's blacklist and change detection, the
rank-preserving assignment round after round, the notification manager,
the ``run`` wrapper's hard and soft resets and reset limit, the driver end
to end (success, a failing host blacklisted, the output appended across
rounds, the reset limit), the launcher's five elastic flags and knobs, the
loopback-alias rule on a machine with cards (the card count simulated, as
test_torch_runner.py does), and the reused-port check between rounds."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import socket  # noqa: E402
import stat  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import pytest  # noqa: E402

from horovod_tpu_torch.common.exceptions import (  # noqa: E402
    HorovodInternalError, HostsUpdatedInterrupt)
from horovod_tpu_torch.elastic import (ElasticDriver, FixedHosts,  # noqa: E402
                                       HostDiscoveryScript, State,
                                       WorkerNotificationManager, run)
from horovod_tpu_torch.elastic import driver as TD  # noqa: E402
from horovod_tpu_torch.runner import hosts as H  # noqa: E402
from horovod_tpu_torch.runner import launch as TLN  # noqa: E402
from horovod_tpu_torch.runner.http_client import put_kv  # noqa: E402
from horovod_tpu_torch.runner.http_server import RendezvousServer  # noqa: E402

from torch_port_ports import hold_ports  # noqa: E402


def _script(tmp_path, lines, name="discover.sh"):
    path = tmp_path / name
    path.write_text("#!/bin/sh\n" + "".join(f"echo '{ln}'\n" for ln in lines))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _driver(discovery, **kw):
    coord, ctrl = hold_ports(2).release()
    kw.setdefault("coordinator_port", coord)
    kw.setdefault("controller_port", ctrl)
    return ElasticDriver(discovery, **kw)


# ----------------------------------------------------------- host manager
def test_host_manager_blacklist_and_change_match_jax():
    from horovod_tpu.elastic import discovery as JD
    from horovod_tpu.runner import hosts as JH
    views = []
    for D, HM in ((JD, JH), (None, H)):
        mod = D if D is not None else sys.modules[
            "horovod_tpu_torch.elastic.discovery"]
        fixed = mod.FixedHosts(HM.parse_hosts("a:1,b:1"))
        mgr = mod.HostManager(fixed)
        seen = [[h.hostname for h in mgr.current_hosts()]]
        mgr.blacklist("b")
        seen.append([h.hostname for h in mgr.current_hosts()])
        cur, changed = mgr.update_available_hosts(mgr.current_hosts())
        seen.append(changed)
        fixed.set(HM.parse_hosts("a:1,c:2"))
        cur, changed = mgr.update_available_hosts(cur)
        seen += [changed, [(h.hostname, h.slots) for h in cur],
                 mgr.is_blacklisted("b"), mgr.is_blacklisted("c")]
        fixed.set(HM.parse_hosts("a:1,c:3"))
        seen.append(mgr.update_available_hosts(cur)[1])  # a slot change
        views.append(seen)
    assert views[0] == views[1]
    assert views[1][:3] == [["a", "b"], ["a"], False]


def test_discovery_script_parses_hosts_and_default_slots(tmp_path):
    path = _script(tmp_path, ["# a comment", "h1:4", "", "h2"])
    got = HostDiscoveryScript(path, default_slots=2).find_available_hosts()
    assert [(h.hostname, h.slots) for h in got] == [("h1", 4), ("h2", 2)]
    bad = tmp_path / "bad.sh"
    bad.write_text("#!/bin/sh\nexit 3\n")
    bad.chmod(0o755)
    with pytest.raises(RuntimeError, match="rc=3"):
        HostDiscoveryScript(str(bad)).find_available_hosts()


ROUNDS = ["a:2,b:2", "c:2,b:2", "b:1,c:2,d:2", "d:4", "e:1,d:1,a:2"]


@pytest.mark.parametrize("max_np", [3, 4, 16])
def test_compute_assignments_match_jax_round_after_round(max_np):
    from horovod_tpu.elastic.discovery import FixedHosts as JFixed
    from horovod_tpu.elastic.driver import ElasticDriver as JDriver
    from horovod_tpu.runner import hosts as JH
    jd = JDriver(JFixed(JH.parse_hosts(ROUNDS[0])), min_np=1, max_np=max_np,
                 command=["true"])
    td = _driver(FixedHosts(H.parse_hosts(ROUNDS[0])), min_np=1,
                 max_np=max_np, command=["true"])
    try:
        for spec in ROUNDS:
            want = jd.compute_assignments(JH.parse_hosts(spec))
            got = td.compute_assignments(H.parse_hosts(spec))
            assert [s.to_env() for s in got] == [s.to_env() for s in want]
        # the JAX test's walk: rank 0 stays on a surviving host
        td2 = _driver(FixedHosts([]), min_np=1, max_np=4, command=["true"])
        try:
            td2.compute_assignments(H.parse_hosts("a:2,b:2"))
            slots = td2.compute_assignments(H.parse_hosts("c:2,b:2"))
            assert [s.hostname for s in slots] == ["b", "b", "c", "c"]
        finally:
            td2.rendezvous.stop()
    finally:
        jd.rendezvous.stop()
        td.rendezvous.stop()


# ------------------------------------------------------------- the worker
def test_worker_notification_manager():
    srv = RendezvousServer()
    port = srv.start()
    try:
        notifier = WorkerNotificationManager("127.0.0.1", port,
                                             poll_interval=0.05)
        assert not notifier.host_updated()
        put_kv("127.0.0.1", port, "elastic", "host_update_counter", b"1")
        deadline = time.time() + 5
        while not notifier.host_updated() and time.time() < deadline:
            time.sleep(0.05)
        assert notifier.host_updated()
        notifier.acknowledge()
        assert not notifier.host_updated()
        notifier.stop()
        # no rendezvous: never updated, never raises
        quiet = WorkerNotificationManager("", 0)
        assert not quiet.host_updated() and quiet._thread is None
    finally:
        srv.stop()


@pytest.fixture
def cpu_runtime():
    import horovod_tpu_torch as hvd
    rt = hvd.init(device="cpu")
    yield rt
    hvd.shutdown()


def test_run_wrapper_hard_reset_reinitializes_in_process(cpu_runtime):
    import horovod_tpu_torch as hvd
    calls = {"n": 0}
    state = State(counter=10)
    first = hvd.runtime.get()

    @run
    def train(st):
        calls["n"] += 1
        if calls["n"] == 1:
            st.counter = 999  # corrupted progress, must roll back
            raise HorovodInternalError("simulated peer death")
        return st.counter, hvd.runtime.get()

    counter, rt = train(state)
    assert counter == 10 and calls["n"] == 2
    assert rt is not first and rt.device.type == "cpu"
    assert hvd.is_initialized()


def test_run_wrapper_soft_reset(cpu_runtime):
    calls = {"n": 0}
    state = State(counter=0)
    resets = []
    state.register_reset_callbacks([lambda: resets.append(1)])

    @run
    def train(st):
        calls["n"] += 1
        if calls["n"] == 1:
            raise HostsUpdatedInterrupt()
        st.counter += 1
        return st.counter

    assert train(state) == 1
    assert calls["n"] == 2 and resets == [1]


def test_run_wrapper_reset_limit(cpu_runtime, monkeypatch):
    monkeypatch.setenv("HOROVOD_ELASTIC_RESET_LIMIT", "2")
    calls = {"n": 0}

    @run
    def train(st):
        calls["n"] += 1
        raise HostsUpdatedInterrupt()

    with pytest.raises(RuntimeError, match="reset limit"):
        train(State(x=0))
    assert calls["n"] == 3


# ------------------------------------------------------ driver end to end
def test_elastic_driver_end_to_end_success(tmp_path):
    disc = _script(tmp_path, ["localhost:2"])
    marker = tmp_path / "ran"
    cmd = [sys.executable, "-c",
           f"import os; open(r'{marker}_'+os.environ['HOROVOD_RANK'],"
           f"'w').write(os.environ['HOROVOD_ELASTIC_ROUND'])"]
    d = _driver(HostDiscoveryScript(disc), min_np=2, max_np=2, command=cmd,
                elastic_timeout=20)
    assert d.run() == 0
    assert (tmp_path / "ran_0").read_text() == "0"
    assert (tmp_path / "ran_1").read_text() == "0"


def test_elastic_driver_blacklists_failing_host(tmp_path):
    disc = _script(tmp_path, ["localhost:1"])
    d = _driver(HostDiscoveryScript(disc), min_np=1, max_np=1,
                command=[sys.executable, "-c", "import sys; sys.exit(1)"],
                elastic_timeout=2)
    with pytest.raises(TimeoutError):
        d.run()
    assert d.host_manager.is_blacklisted("localhost")


def test_elastic_driver_appends_output_across_rounds(tmp_path):
    """A rank's output file continues across reset rounds (truncated on
    the driver's first spawn only); the failing round's alias is
    blacklisted and the next round runs on the other."""
    disc = _script(tmp_path, ["localhost:1", "127.0.0.1:1"])
    outdir = tmp_path / "logs"
    (outdir / "rank.0").mkdir(parents=True)
    (outdir / "rank.0" / "stdout").write_text("stale log of an earlier run\n")
    flag = tmp_path / "failed_once"
    cmd = [sys.executable, "-c",
           "import os, sys; e = os.environ; "
           "print('round', e['HOROVOD_ELASTIC_ROUND'], e['HOROVOD_HOSTNAME']); "
           f"f = r'{flag}'; first = not os.path.exists(f); "
           "open(f, 'w').close(); sys.exit(1 if first else 0)"]
    d = _driver(HostDiscoveryScript(disc), min_np=1, max_np=1, command=cmd,
                elastic_timeout=20, output_filename=str(outdir))
    assert d.run() == 0
    text = (outdir / "rank.0" / "stdout").read_text()
    assert text == "round 0 127.0.0.1\nround 1 localhost\n"
    assert d.host_manager.is_blacklisted("127.0.0.1")


def test_elastic_driver_reset_limit(tmp_path):
    disc = _script(tmp_path, ["localhost:1", "127.0.0.1:1", "127.0.0.2:1"])
    d = _driver(HostDiscoveryScript(disc), min_np=1, max_np=1,
                command=[sys.executable, "-c", "import sys; sys.exit(1)"],
                elastic_timeout=20, reset_limit=1)
    assert d.run() == 1
    assert d.host_manager.is_blacklisted("127.0.0.1")
    assert d.host_manager.is_blacklisted("127.0.0.2")
    assert not d.host_manager.is_blacklisted("localhost")


# ---------------------------------------------------------- the launcher
ELASTIC_FLAGS = {"min_np": ["--min-np", "2"], "max_np": ["--max-np", "3"],
                 "host_discovery_script": ["--host-discovery-script", "s"],
                 "elastic_timeout": ["--elastic-timeout", "7"],
                 "reset_limit": ["--reset-limit", "4"]}


@pytest.mark.parametrize("dest", sorted(ELASTIC_FLAGS))
def test_launcher_accepts_the_elastic_flags(dest):
    from horovod_tpu.runner import launch as JLN
    argv = ELASTIC_FLAGS[dest]
    args = TLN.make_parser().parse_args(argv)
    assert getattr(args, dest) is not None
    assert TLN.refused_flag(args) is None
    jenv = JLN.args_to_env(JLN.make_parser().parse_args(argv))
    tenv = TLN.args_to_env(args)
    for name in ("HOROVOD_ELASTIC_TIMEOUT", "HOROVOD_ELASTIC_RESET_LIMIT"):
        assert tenv.get(name) == jenv.get(name)


def test_elastic_knobs_match_jax():
    from horovod_tpu.common.knobs import Knobs as JK
    from horovod_tpu_torch.common.knobs import Knobs as TK
    for name in ("HOROVOD_ELASTIC_TIMEOUT", "HOROVOD_ELASTIC_RESET_LIMIT",
                 "HOROVOD_ELASTIC_ROUND"):
        assert TK()[name] == JK()[name]


def test_scenario_is_still_refused(tmp_path, capsys):
    """``--scenario`` is a flag of the port now (ROADMAP item 4.5); a spec
    that does not parse is still refused at launch, before any rank
    starts."""
    bad = tmp_path / "bad.json"
    bad.write_text('{"name": "x"}')
    assert TLN.run_commandline(["--scenario", str(bad), "-np", "1",
                                "true"]) == 2
    assert "'phases'" in capsys.readouterr().err


def test_launcher_runs_elastic_without_np(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    disc = _script(tmp_path, ["localhost:1"])
    coord, ctrl = hold_ports(2).release()
    out = tmp_path / "ok"
    assert TLN.run_commandline([
        "--min-np", "1", "--max-np", "1", "--host-discovery-script", disc,
        "--elastic-timeout", "10", "--reset-limit", "1",
        "--coordinator-port", str(coord), "--controller-port", str(ctrl),
        sys.executable, "-c",
        f"import os; open(r'{out}', 'w').write(os.environ["
        "'HOROVOD_ELASTIC_TIMEOUT'] + os.environ['HOROVOD_SIZE'])"]) == 0
    assert out.read_text() == "101"
    # elastic mode needs the discovery script
    assert TLN.run_commandline(["--min-np", "1", sys.executable, "-c",
                                "pass"]) == 2


# ------------------------------------------- loopback aliases and ports
def test_mixed_aliases_on_a_card_machine_raise(tmp_path, monkeypatch):
    """Two loopback aliases of a machine with cards, both in one round:
    every alias's ranks start at local rank 0, so two ranks would take one
    card.  One alias a round passes; so do mixed aliases without cards."""
    from horovod_tpu_torch.runner import gpu_discovery
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(gpu_discovery, "_smi_count", lambda: 2)
    d = _driver(FixedHosts([]), min_np=1, max_np=4, command=["true"])
    try:
        mixed = d.compute_assignments(H.parse_hosts("localhost:1,127.0.0.1:1"))
        with pytest.raises(ValueError, match="same card"):
            d.check_card_aliases(mixed)
        d.check_card_aliases(d.compute_assignments(
            H.parse_hosts("localhost:2")))
        d.check_card_aliases(d.compute_assignments(
            H.parse_hosts("127.0.0.1:1,otherhost:1")))
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
        d.check_card_aliases(mixed)  # no visible card: a CPU job may mix
    finally:
        d.rendezvous.stop()
    # end to end through the launcher: the round fails before it spawns
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    disc = _script(tmp_path, ["localhost:1", "127.0.0.1:1"])
    coord, ctrl = hold_ports(2).release()
    assert TLN.run_commandline([
        "--min-np", "2", "--max-np", "2", "--host-discovery-script", disc,
        "--coordinator-port", str(coord), "--controller-port", str(ctrl),
        sys.executable, "-c", "raise SystemExit(5)"]) == 2


def test_a_held_port_fails_the_round_at_once(monkeypatch):
    monkeypatch.setattr(TD, "PORT_PATIENCE_S", 0.3)
    holder = socket.socket()
    holder.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    holder.bind(("", 0))
    holder.listen(1)
    port = holder.getsockname()[1]
    d = _driver(FixedHosts([]), min_np=1, max_np=1, command=["true"],
                coordinator_port=port)
    try:
        t0 = time.time()
        with pytest.raises(RuntimeError, match=f"coordinator port {port}"):
            d.check_ports()
        assert time.time() - t0 < 5
        holder.close()
        d.check_ports()  # free again
        assert TD.port_bindable(port)
    finally:
        holder.close()
        d.rendezvous.stop()
