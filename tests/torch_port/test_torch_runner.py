"""The port's launcher (``horovod_tpu_torch/runner/``) against the JAX
package's (``horovod_tpu/runner/``), function by function on the same
inputs: host specs and slot assignment, the env blocks, the CLI's knobs
and config file, the worker command, the coordinator address, LSF hosts,
the scope->shard map, GPU discovery with an injected device count, the
rendezvous KV's wire protocol in both directions (sharded too), the
measurement plane's flags and routes (``/metrics``, ``/clock``,
``/timeline``), and every refused flag.  Nothing here spawns a worker
(``test_torch_runner_gloo.py`` does)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402
import socket  # noqa: E402
import textwrap  # noqa: E402
import time  # noqa: E402

import pytest  # noqa: E402

from horovod_tpu.runner import hosts as JH  # noqa: E402
from horovod_tpu.runner import http_client as JC  # noqa: E402
from horovod_tpu.runner import kvshard as JK  # noqa: E402
from horovod_tpu.runner import launch as JL  # noqa: E402
from horovod_tpu.runner.http_server import \
    RendezvousServer as JServer  # noqa: E402
from horovod_tpu.runner.lsf import lsf_hosts as j_lsf_hosts  # noqa: E402

from horovod_tpu_torch.runner import gpu_discovery as GD  # noqa: E402
from horovod_tpu_torch.runner import hosts as TH  # noqa: E402
from horovod_tpu_torch.runner import http_client as TC  # noqa: E402
from horovod_tpu_torch.runner import kvshard as TK  # noqa: E402
from horovod_tpu_torch.runner import launch as TL  # noqa: E402
from horovod_tpu_torch.runner.http_server import (  # noqa: E402
    PLANE_ROUTES, RendezvousServer as TServer, kv_shard_health)
from horovod_tpu_torch.runner.lsf import \
    lsf_hosts as t_lsf_hosts  # noqa: E402


def _outcome(fn, *args, **kwargs):
    """``("ok", value)`` or ``("raise", type name, message)``."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 - compared, not swallowed
        return ("raise", type(e).__name__, str(e))


def _slots(slots):
    return [vars(s) for s in slots]


# ------------------------------------------------------------------- hosts
@pytest.mark.parametrize("spec", [
    "h1:4,h2:2,h3", "localhost:8", "a", " a:2 , b:3 ", "", ",", "h1:2,h1:2",
    ":4", "h:x"])
def test_parse_hosts_matches_jax(spec):
    got = _outcome(TH.parse_hosts, spec)
    want = _outcome(JH.parse_hosts, spec)
    if got[0] == "ok":
        got = ("ok", [vars(h) for h in got[1]])
        want = ("ok", [vars(h) for h in want[1]])
    assert got == want


@pytest.mark.parametrize("spec,np_,min_np", [
    ("localhost:4", 4, 0), ("a:2,b:2", 4, 0), ("a:2,b:2", 3, 0),
    ("a:1,b:3,c:2", 5, 0), ("a:2,b:2", 1, 0), ("a:2", 3, 0),
    ("a:2,b:1", 2, 4), ("a:4,b:4,c:4", 12, 12)])
def test_host_assignments_match_jax(spec, np_, min_np):
    got = _outcome(TH.get_host_assignments, TH.parse_hosts(spec), np_,
                   min_np)
    want = _outcome(JH.get_host_assignments, JH.parse_hosts(spec), np_,
                    min_np)
    if got[0] == "ok":
        assert [s.to_env() for s in got[1]] == \
            [s.to_env() for s in want[1]]
        got, want = ("ok", _slots(got[1])), ("ok", _slots(want[1]))
    assert got == want


@pytest.mark.parametrize("hostnames,port", [
    (["h1"], 29500), (["a", "b", "a", "c", "b"], 1234),
    (["x", "x", "x", "x"], 29515), (["b", "a"], 7)])
def test_env_for_tasks_matches_jax(hostnames, port):
    assert TH.env_for_tasks(hostnames, port) == \
        JH.env_for_tasks(hostnames, port)


# --------------------------------------------------------------- CLI -> env
_SHARED_ARGVS = [
    ["--fusion-threshold-mb", "64", "--cycle-time-ms", "2.5"],
    ["--cache-capacity", "16"],
    ["--disable-cache", "--hierarchical-allreduce",
     "--no-hierarchical-allgather"],
    ["--no-hierarchical-allreduce", "--hierarchical-allgather"],
    ["--start-timeout", "60", "--gloo-timeout-seconds", "45"],
    ["--stall-check-warning-time-seconds", "30"],
    ["--stall-check-time-seconds", "12", "--stall-check"],
    ["--no-timeline-mark-cycles", "--log-with-timestamp"],
    ["-H", "a:2,b:2", "--ssh-port", "22", "--verbose", "--tcp"],
    [],
    ["--metrics-port", "9100", "--timeline-filename", "/tmp/tl.json",
     "--timeline-mark-cycles", "--timeline-merge", "/tmp/merged.json"],
    ["--autotune", "--autotune-log-file", "/tmp/at.csv",
     "--autotune-warmup-samples", "1", "--autotune-steps-per-sample", "2",
     "--autotune-bayes-opt-max-samples", "7",
     "--autotune-gaussian-process-noise", "0.3"],
    ["--no-stall-check", "--stall-check-shutdown-time-seconds", "90",
     "--log-level", "debug", "--log-without-timestamp"],
]


@pytest.mark.parametrize("flags", _SHARED_ARGVS,
                         ids=lambda f: " ".join(f) or "none")
def test_args_to_env_matches_jax(flags):
    argv = ["-np", "2"] + flags + ["python", "t.py"]
    got = TL.args_to_env(TL.make_parser().parse_args(argv))
    want = JL.args_to_env(JL.make_parser().parse_args(argv))
    assert got == want
    assert TL.refused_flag(TL.make_parser().parse_args(argv)) is None


def test_parser_takes_every_jax_flag():
    """Every option string of the JAX parser parses here (refused or not),
    and the port adds only ``--gpu`` and ``--serve-device`` (the serving
    workers' explicit device: the only way onto the CPU)."""
    def options(parser):
        return {o for a in parser._actions for o in a.option_strings}
    jax_opts, port_opts = options(JL.make_parser()), options(TL.make_parser())
    assert jax_opts <= port_opts
    assert port_opts - jax_opts == {"--gpu", "--serve-device"}


def _cfg(tmp_path, text):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(textwrap.dedent(text))
    return str(cfg)


def test_config_file_to_env_matches_jax(tmp_path):
    path = _cfg(tmp_path, """
        params:
          fusion_threshold_mb: 32
          cycle_time_ms: 3.0
          cache_capacity: 7
        stall_check:
          warning_time_seconds: 120
    """)
    got, want = {}, {}
    TL.config_file_to_env(path, got)
    JL.config_file_to_env(path, want)
    assert got == want == {
        "HOROVOD_FUSION_THRESHOLD": str(32 * 1024 * 1024),
        "HOROVOD_CYCLE_TIME": "3.0", "HOROVOD_CACHE_CAPACITY": "7",
        "HOROVOD_STALL_CHECK_TIME_SECONDS": "120"}


def test_cli_flag_beats_config_like_jax(tmp_path):
    path = _cfg(tmp_path, "params:\n  fusion_threshold_mb: 32\n"
                "  cycle_time_ms: 4.0\n")
    argv = ["-np", "1", "--config-file", path, "--fusion-threshold-mb", "8",
            "python", "t.py"]
    got = TL.args_to_env(TL.make_parser().parse_args(argv))
    assert got == JL.args_to_env(JL.make_parser().parse_args(argv))
    assert got["HOROVOD_FUSION_THRESHOLD"] == str(8 * 1024 * 1024)
    assert got["HOROVOD_CYCLE_TIME"] == "4.0"


@pytest.mark.parametrize("text,item", [
    ("params:\n  mesh: data=8\n", "HOROVOD_LAYOUT")])
def test_config_file_refuses_keys_of_missing_planes(tmp_path, text, item):
    with pytest.raises(ValueError, match=item):
        TL.config_file_to_env(_cfg(tmp_path, text), {})


@pytest.mark.parametrize("text", [
    "timeline:\n  filename: /tmp/tl.json\n  mark_cycles: true\n",
    "autotune:\n  enabled: true\n  log_file: /tmp/at.csv\n",
    "stall_check:\n  disable: true\n  shutdown_time_seconds: 30\n"])
def test_config_file_measure_keys_match_jax(tmp_path, text):
    """The timeline, autotune and stall_check sections map to the JAX
    launcher's knobs."""
    got, want = {}, {}
    TL.config_file_to_env(_cfg(tmp_path, text), got)
    JL.config_file_to_env(_cfg(tmp_path, text), want)
    assert got == want and got


def test_no_effect_flags_warn(capsys):
    args = TL.make_parser().parse_args(
        ["-np", "2", "--binding-args", "-bind-to socket", "--num-streams",
         "4", "python", "t.py"])
    assert TL.args_to_env(args) == {}
    err = capsys.readouterr().err
    assert "--binding-args has no effect" in err
    assert "--num-streams has no effect" in err


# ------------------------------------------------------- workers, addresses
@pytest.mark.parametrize("rank,env,ssh_port,identity", [
    (0, {}, None, None), (1, {"HOROVOD_RANK": "1"}, 2222, None),
    (1, {"B": "two words", "A": "x;y"}, None, "/k/id_rsa"),
    (2, {"HOROVOD_RANK": "2"}, 22, "id")])
def test_build_worker_command_matches_jax(rank, env, ssh_port, identity):
    spec = "localhost:1,remotehost:1,127.0.0.2:1"
    tslot = TH.get_host_assignments(TH.parse_hosts(spec), 3)[rank]
    jslot = JH.get_host_assignments(JH.parse_hosts(spec), 3)[rank]
    cmd = ["python", "t.py", "--flag", "a b"]
    got = TL.build_worker_command(tslot, cmd, env, ssh_port, identity)
    assert got == JL.build_worker_command(jslot, cmd, env, ssh_port,
                                          identity)
    assert (got[0] == "ssh") == (rank == 1)


@pytest.mark.parametrize("host,nic,remote", [
    ("localhost", None, False), ("localhost", None, True),
    ("127.0.0.1", None, True), (socket.gethostname(), None, True),
    ("127.0.0.3", None, False), ("far-away-host", "eth0", True),
    ("far-away-host", None, True), ("lo-only", "lo", False)])
def test_resolve_coord_host_matches_jax(host, nic, remote):
    tw, jw = [], []
    got = _outcome(TL.resolve_coord_host, host, nic, warn=tw.append,
                   has_remote_workers=remote)
    want = _outcome(JL.resolve_coord_host, host, nic, warn=jw.append,
                    has_remote_workers=remote)
    assert got == want
    assert len(tw) == len(jw)


# ---------------------------------------------------------------------- LSF
def test_lsf_hosts_match_jax(tmp_path, monkeypatch):
    """tests/test_runner.py:346's allocations, in both packages."""
    hf = tmp_path / "hostfile"
    hf.write_text("batch1\nbatch1\nnode2\nnode2\nnode2\n")
    for environ in ({"LSB_DJOB_HOSTFILE": str(hf)},
                    {"LSB_HOSTS": "a a b"}, {},
                    {"LSB_DJOB_HOSTFILE": str(tmp_path / "gone"),
                     "LSB_HOSTS": "x y x"}):
        got, want = t_lsf_hosts(environ), j_lsf_hosts(environ)
        assert (got is None) == (want is None)
        if got is not None:
            assert [vars(h) for h in got] == [vars(h) for h in want]
    assert [(h.hostname, h.slots) for h in t_lsf_hosts(
        {"LSB_DJOB_HOSTFILE": str(hf)})] == [("batch1", 2), ("node2", 3)]
    # wired through resolve_hosts as in the JAX launcher
    monkeypatch.setenv("LSB_HOSTS", "lsfa lsfa lsfb")
    monkeypatch.delenv("LSB_DJOB_HOSTFILE", raising=False)
    for argv in (["-np", "3", "cmd"], ["-np", "2", "-H", "x:2", "cmd"]):
        assert [vars(h) for h in TL.resolve_hosts(
            TL.make_parser().parse_args(argv))] == \
            [vars(h) for h in JL.resolve_hosts(
                JL.make_parser().parse_args(argv))]
    monkeypatch.setenv("LSB_HOSTS", "onehost")
    args = TL.make_parser().parse_args(["-np", "4", "cmd"])
    assert [(h.hostname, h.slots) for h in TL.resolve_hosts(args)] == \
        [("localhost", 4)]


# --------------------------------------------------------- scope -> shard
_SCOPES = (["metrics", "health", "timeline", "perf", "chaos", "serve",
            "serve_req", "serve_out", "serve_plan", "serve_journal", "rank",
            "host_update", "kvshard", "run", "", "é-ünï", "serve_out.r01"]
           + [f"scope.{i}" for i in range(300)])


@pytest.mark.parametrize("nshards", range(1, 9))
def test_shard_for_scope_matches_jax(nshards):
    assert [TK.shard_for_scope(s, nshards) for s in _SCOPES] == \
        [JK.shard_for_scope(s, nshards) for s in _SCOPES]
    assert TK.scope_table(_SCOPES, nshards) == \
        JK.scope_table(_SCOPES, nshards)


@pytest.mark.parametrize("spec", [
    "h:1,h2:2", " a:10 , , b:20 ", "", "10.0.0.1:5", "nohost", ":5", "h:x"])
def test_shard_addrs_match_jax(spec):
    got = _outcome(TK.parse_shard_addrs, spec)
    assert got == _outcome(JK.parse_shard_addrs, spec)
    if got[0] == "ok":
        assert TK.format_shard_addrs(got[1]) == \
            JK.format_shard_addrs(got[1])


# ---------------------------------------------------------- GPU discovery
@pytest.mark.parametrize("cards,visible,want", [
    (8, None, 8), (8, "0,1,2", 3), (8, "", 0), (4, "0,1,-1,2", 2),
    (2, "0,1,2,3", 2), (0, None, 0), (4, "GPU-abc,GPU-def", 2)])
def test_visible_gpu_count(cards, visible, want):
    environ = {} if visible is None else {"CUDA_VISIBLE_DEVICES": visible}
    assert GD.visible_gpu_count(environ, lambda: cards) == want
    hosts = GD.discover_gpu_hosts(environ=environ, count_fn=lambda: cards)
    assert (hosts is None) == (want == 0)
    if want:
        assert [vars(h) for h in hosts] == [{"hostname": "localhost",
                                             "slots": want}]


def test_gpu_slots_flag_bounds():
    assert GD.discover_gpu_hosts(2, {}, lambda: 4)[0].slots == 2
    with pytest.raises(ValueError, match="NCCL cannot put two ranks"):
        GD.discover_gpu_hosts(5, {}, lambda: 4)


def test_gpu_flag_defaults_np_like_explicit_hosts(monkeypatch):
    """``--gpu`` without -np gives the slots an explicit ``-H
    localhost:<cards>`` gives, in both launchers (JAX:
    test_tpu_flag_defaults_np_like_explicit_hosts)."""
    monkeypatch.setattr(GD, "_smi_count", lambda: 4)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    hosts = TL.resolve_hosts(TL.make_parser().parse_args(["--gpu", "cmd"]))
    np_ = sum(h.slots for h in hosts)
    got = TH.get_host_assignments(hosts, np_)
    want = JH.get_host_assignments(JL.resolve_hosts(JL.make_parser(
        ).parse_args(["-H", "localhost:4", "cmd"])), 4)
    assert _slots(got) == _slots(want)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1,3")
    assert TL.resolve_hosts(TL.make_parser().parse_args(
        ["--gpu", "cmd"]))[0].slots == 2


def test_gpu_flag_refuses_np_beyond_the_cards(monkeypatch, capsys):
    monkeypatch.setattr(GD, "_smi_count", lambda: 2)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert TL.run_commandline(["-np", "3", "--gpu", "python", "-c",
                               "1"]) == 2
    assert "NCCL cannot put two ranks on one card" in capsys.readouterr().err
    monkeypatch.setattr(GD, "_smi_count", lambda: 0)
    assert TL.run_commandline(["--gpu", "python", "-c", "1"]) == 2
    assert "no CUDA device visible" in capsys.readouterr().err
    assert TL.run_commandline(["--gpu", "-H", "a:1", "python"]) == 2


# ------------------------------------------------ the KV's wire protocol
def _raw(port, request: bytes) -> bytes:
    """One raw HTTP exchange; the response with its Date header dropped."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(request)
        chunks = []
        while True:
            b = s.recv(65536)
            if not b:
                break
            chunks.append(b)
    lines = b"".join(chunks).split(b"\r\n")
    return b"\r\n".join(ln for ln in lines if not ln.startswith(b"Date:"))


_REQUESTS = [
    b"PUT /scope/key HTTP/1.1\r\nHost: x\r\nContent-Length: 5\r\n"
    b"Connection: close\r\n\r\nhello",
    b"GET /scope/key HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
    b"GET /scope/missing HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
    b"PUT /rank/0 HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n"
    b"Connection: close\r\n\r\n",
    b"GET /rank/0 HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
    b"GET /scope/key?x=1 HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
    b"DELETE /scope/key HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
    b"DELETE /scope/key HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
    b"POST /scope/key HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n"
    b"Connection: close\r\n\r\n",
]


@pytest.fixture(scope="module")
def servers():
    j, t = JServer(host="127.0.0.1"), TServer(host="127.0.0.1")
    jp, tp = j.start(), t.start()
    yield jp, tp
    j.stop()
    t.stop()


def test_wire_bytes_equal_jax_server(servers):
    jp, tp = servers
    for req in _REQUESTS:
        assert _raw(tp, req) == _raw(jp, req), req


@pytest.mark.parametrize("direction", ["port client, JAX server",
                                       "JAX client, port server"])
def test_kv_protocol_both_directions(servers, direction):
    jp, tp = servers
    client, port = (TC, jp) if direction.startswith("port") else (JC, tp)
    value = bytes(range(256)) * 33
    client.put_kv("127.0.0.1", port, "proto", "blob", value)
    assert client.get_kv("127.0.0.1", port, "proto", "blob") == value
    assert client.get_kv("127.0.0.1", port, "proto", "absent",
                         timeout=0) is None
    assert client.delete_kv("127.0.0.1", port, "proto", "blob")
    assert not client.delete_kv("127.0.0.1", port, "proto", "blob")
    assert client.get_kv("127.0.0.1", port, "proto", "blob",
                         timeout=0) is None


@pytest.mark.parametrize("direction", ["port client, JAX server",
                                       "JAX client, port server"])
def test_sharded_kv_both_directions(direction):
    port_client = direction.startswith("port")
    server = (JServer if port_client else TServer)(host="127.0.0.1",
                                                     shards=3)
    server.start()
    addrs = [("127.0.0.1", p) for p in server.shard_ports]
    client = TC if port_client else JC
    try:
        routed = client.ShardedKVClient(addrs)
        for scope in ("rank", "run", "metrics", "kvshard", "serve_out"):
            routed.put(scope, "k", scope.encode() * 3)
        stores = server._httpd.kv_stores
        for scope in ("rank", "run", "metrics", "kvshard", "serve_out"):
            own = TK.shard_for_scope(scope, 3)
            assert stores[own].kv[scope]["k"] == scope.encode() * 3
            assert routed.get(scope, "k", timeout=2) == scope.encode() * 3
            assert server.get(scope, "k") == scope.encode() * 3
        # the module-level functions route by the installed map too
        client.install_shard_map(addrs)
        client.put_kv("127.0.0.1", addrs[0][1], "serve_plan", "t", b"p")
        own = TK.shard_for_scope("serve_plan", 3)
        assert stores[own].kv["serve_plan"]["t"] == b"p"
        server.publish_shard_map("127.0.0.1")
        doc = json.loads(client.get_kv("127.0.0.1", addrs[0][1], "kvshard",
                                       "map", timeout=2))
        assert doc == {"n": 3, "addrs": [f"{a}:{p}" for a, p in addrs]}
    finally:
        client.install_shard_map(None)
        server.stop()


def test_port_server_shards_and_harvest_after_stop():
    server = TServer(host="127.0.0.1", shards=3)
    port = server.start()
    server.put("rank", "0", b"a")
    TC.put_kv("127.0.0.1", port, "other", "x", b"b")
    rows = kv_shard_health(server._httpd)
    assert [r["shard"] for r in rows] == [0, 1, 2]
    assert sum(r["keys"] for r in rows) == 2
    server.stop_shard(2)
    assert not kv_shard_health(server._httpd)[2]["alive"]
    with pytest.raises(ValueError):
        server.stop_shard(0)
    server.stop()
    assert server.get("rank", "0") == b"a"
    assert server.scope_items("rank") == {"0": b"a"}
    assert set(server.scope_receipt_times("rank")) == {"0"}


def _split_http(raw: bytes):
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.split(b"\r\n")
    headers = {k: v for k, _, v in (ln.partition(b": ")
                                    for ln in lines[1:])}
    return lines[0], headers, body


@pytest.mark.parametrize("scope", ["metrics", "clock", "timeline"])
def test_measure_routes_answer(servers, scope):
    """The measurement plane's routes answer as the JAX server's do:
    ``/clock`` its wall time, ``/timeline`` the same merge of the same
    chunks byte for byte, ``/metrics`` a lint-clean exposition with the
    driver's row and, for the same worker snapshot, the same rank-labeled
    lines."""
    from horovod_tpu.utils import metrics as JM
    from horovod_tpu_torch.utils import metrics as TM
    assert ("GET", scope, "") not in PLANE_ROUTES
    jp, tp = servers
    if scope == "timeline":
        chunk = json.dumps({"rank": 1, "seq": 0, "clock": {
            "offset": 0.25, "uncertainty": 1e-4, "synced": True},
            "events": [{"name": "EXEC", "ph": "X", "ts": 5.0e6, "dur": 7.0,
                        "lane": "grad.w", "args": {"size": 64}},
                       {"name": "CYCLE", "ph": "i", "s": "p", "ts": 4.0e6,
                        "lane": "controller"}]}).encode()
        for port in (jp, tp):
            TC.put_kv("127.0.0.1", port, "timeline", "rank.1.000000", chunk)
    if scope == "metrics":
        snap = TM.MetricsRegistry()
        snap.counter("hvd_collective_ops_total", "x").inc(3, op="allreduce")
        body = dict(snap.snapshot(), rank=0)
        for port in (jp, tp):
            TC.put_kv("127.0.0.1", port, "metrics", "rank.0",
                      json.dumps(body).encode())
    req = (f"GET /{scope} HTTP/1.1\r\nHost: x\r\nConnection: close"
           "\r\n\r\n").encode()
    t_status, t_head, t_body = _split_http(_raw(tp, req))
    j_status, j_head, j_body = _split_http(_raw(jp, req))
    assert t_status == j_status == b"HTTP/1.0 200 OK"
    assert t_head[b"Content-Type"] == j_head[b"Content-Type"]
    assert t_head[b"Server"] == j_head[b"Server"]
    if scope == "clock":
        for b in (t_body, j_body):
            assert abs(float(b) - time.time()) < 5.0
    elif scope == "timeline":
        assert t_body == j_body
        merged = json.loads(t_body)
        assert merged["metadata"]["clock_sync"]["1"]["offset"] == 0.25
    else:
        text = t_body.decode()
        assert TM.lint_exposition(text) == []
        assert JM.lint_exposition(text) == []
        assert 'rank="driver"' in text
        assert 'hvd_collective_ops_total{op="allreduce",rank="0"} 3' in text

        def rank0(b):
            return [ln for ln in b.decode().splitlines() if 'rank="0"' in ln]
        assert rank0(t_body) == rank0(j_body)


# the routes the port answered 404 on until their plane (item 4.3) came
_FORENSICS_ROUTES = (("GET", "alerts", ""), ("GET", "health", ""),
                     ("GET", "series", ""))


@pytest.mark.parametrize("route", sorted(set(PLANE_ROUTES)
                                         | set(_FORENSICS_ROUTES)))
def test_plane_routes_wait_for_their_plane(servers, route):
    """Each route the JAX server renders for a plane the port does not have
    yet answers 404, and ROADMAP lists its item; every other one answers
    as the JAX server does (the forensics routes: 200, JSON with the same
    keys)."""
    method, scope, key = route
    jp, tp = servers
    path = f"/{scope}/{key}" if key else f"/{scope}"
    body = b"{}" if method == "POST" else b""
    req = (f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Length: "
           f"{len(body)}\r\nConnection: close\r\n\r\n".encode() + body)
    resp = _raw(tp, req)
    if route in PLANE_ROUTES:
        assert resp.startswith(b"HTTP/1.0 404")
        roadmap = open(os.path.join(os.path.dirname(__file__), "..", "..",
                                    "ROADMAP.md")).read()
        assert f"`{path}`" in roadmap
        assert PLANE_ROUTES[route] in ("3.4", "4.1", "4.2", "4.4", "4.5")
        return
    want = _raw(jp, req)
    assert resp.startswith(b"HTTP/1.0 200") and want.startswith(
        b"HTTP/1.0 200")
    assert set(json.loads(resp.partition(b"\r\n\r\n")[2])) == set(
        json.loads(want.partition(b"\r\n\r\n")[2]))


def _perf_reports(case):
    from horovod_tpu.perf.ledger import PerfLedger
    reports = {}
    for rank, step in enumerate({"empty": [], "one": [0.02],
                                 "two": [0.01, 0.011],
                                 "straggler": [0.01, 0.01, 0.05]}[case]):
        led = PerfLedger()
        led.configure(flops_per_step=1e6, comm_bytes_per_step=8e7)
        for _ in range(3):
            led.record_step(step)
        reports[f"rank.{rank}"] = json.dumps(
            dict(led.report(), rank=rank)).encode()
    return reports


@pytest.mark.parametrize("case", ["empty", "one", "two", "straggler"])
def test_perf_route_answers(servers, case):
    """``GET /perf`` answers as the JAX server's does for the same stored
    reports: the same status and headers, and the same merged view (its
    time stamp dropped)."""
    assert ("GET", "perf", "") not in PLANE_ROUTES
    jp, tp = servers
    for key, value in _perf_reports(case).items():
        for port in (jp, tp):
            TC.put_kv("127.0.0.1", port, "perf", key, value)
    if case != "empty":  # a torn PUT is skipped by both
        for port in (jp, tp):
            TC.put_kv("127.0.0.1", port, "perf", "rank.9", b"{torn")
    req = b"GET /perf HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
    answers = []
    for port in (jp, tp):
        head, _, body = _raw(port, req).partition(b"\r\n\r\n")
        view = json.loads(body)
        view.pop("time")
        answers.append(([ln for ln in head.split(b"\r\n")
                         if not ln.startswith(b"Content-Length")], view))
    assert answers[0] == answers[1]
    assert answers[1][1]["fleet"]["ranks"] == len(_perf_reports(case))


def test_get_kv_default_patience_follows_gloo_timeout_knob(monkeypatch,
                                                            servers):
    monkeypatch.setenv("HOROVOD_GLOO_TIMEOUT_SECONDS", "1")
    _, tp = servers
    t0 = time.monotonic()
    assert TC.get_kv("127.0.0.1", tp, "s", "never") is None
    assert 0.8 <= time.monotonic() - t0 < 5.0


def test_put_kv_retries_then_raises_on_a_dead_server():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    t0 = time.monotonic()
    with pytest.raises(Exception) as e:
        TC.put_kv("127.0.0.1", dead, "s", "k", b"v", retries=2)
    assert TC._transient(e.value)
    assert time.monotonic() - t0 >= 0.1  # two backoffs of >= 50 ms each
    assert len(TC._retry_delays(None)) == 4


# ------------------------------------------------------------- refusals
_MEASURE_FLAGS = {
    "metrics_port": ["--metrics-port", "9100"],
    "timeline_filename": ["--timeline-filename", "/tmp/tl.json"],
    "timeline_merge": ["--timeline-merge", "/tmp/merged.json"],
    "timeline_mark_cycles": ["--timeline-mark-cycles"],
    "autotune": ["--autotune"],
    "autotune_log_file": ["--autotune-log-file", "/tmp/at.csv"],
    "autotune_warmup_samples": ["--autotune-warmup-samples", "2"],
    "autotune_steps_per_sample": ["--autotune-steps-per-sample", "5"],
    "autotune_bayes_opt_max_samples": ["--autotune-bayes-opt-max-samples",
                                       "9"],
    "autotune_gaussian_process_noise": [
        "--autotune-gaussian-process-noise", "0.5"],
    "no_stall_check": ["--no-stall-check"],
    "stall_shutdown_time_seconds": ["--stall-shutdown-time-seconds", "60"],
    "log_level": ["--log-level", "info"],
    "log_hide_timestamp": ["--log-hide-timestamp"],
}


@pytest.mark.parametrize("dest", sorted(_MEASURE_FLAGS))
def test_measure_flags_are_no_longer_refused(dest):
    """The measurement plane's 14 flags parse, pass ``refused_flag`` and
    stamp the JAX launcher's env."""
    argv = ["-np", "1"] + _MEASURE_FLAGS[dest] + ["python", "t.py"]
    args = TL.make_parser().parse_args(argv)
    assert getattr(args, dest) not in (None, False)
    assert TL.refused_flag(args) is None
    assert TL.args_to_env(args) == JL.args_to_env(
        JL.make_parser().parse_args(argv))


_FORENSICS_FLAGS = {"postmortem": "--postmortem", "alerts": "--alerts",
                    "chaos": "--chaos"}


@pytest.mark.parametrize("dest", sorted(_FORENSICS_FLAGS))
def test_forensics_flags_are_no_longer_refused(dest, tmp_path):
    """``--postmortem``, ``--alerts`` and ``--chaos`` (refused until item
    4.3) parse, pass ``refused_flag`` and stamp the JAX launcher's env."""
    value = {"postmortem": str(tmp_path / "pm"),
             "alerts": str(tmp_path / "rules.json"),
             "chaos": str(tmp_path / "chaos.json")}[dest]
    (tmp_path / "rules.json").write_text('{"rules": []}')
    (tmp_path / "chaos.json").write_text(
        '{"seed": 3, "transport": {"drop_rate": 0.5}, "events": []}')
    argv = ["-np", "2", _FORENSICS_FLAGS[dest], value, "python", "t.py"]
    args = TL.make_parser().parse_args(argv)
    assert getattr(args, dest) == value
    assert TL.refused_flag(args) is None
    assert TL.args_to_env(args) == JL.args_to_env(
        JL.make_parser().parse_args(argv))


@pytest.mark.parametrize("argv,needle", [
    (["--mpi"], "torch.distributed"), (["--gloo"], "torch.distributed"),
    (["--jsrun"], "torch.distributed"),
    (["--mpi-args", "x"], "torch.distributed"),
    (["--mesh", "data=8"], "HOROVOD_LAYOUT"), (["--tpu"], "--gpu")])
def test_transport_and_device_flags_exit_2(argv, needle, capsys):
    assert TL.run_commandline(["-np", "1"] + argv + ["python"]) == 2
    assert needle in capsys.readouterr().err


def test_doctor_and_missing_command_exit_2(capsys):
    """``doctor`` on a path without a postmortem.json (its postmortem view,
    item 4.3) exits 2 naming what it could not read, as the JAX doctor
    does; a launch without a command exits 2."""
    assert TL.run_commandline(["doctor", "x"]) == 2
    assert "No such file or directory: 'x'" in capsys.readouterr().err
    assert TL.run_commandline(["-np", "1"]) == 2
    assert TL.run_commandline(["python", "t.py"]) == 2


def test_check_build_and_version(capsys):
    assert TL.run_commandline(["--check-build"]) == 0
    out = capsys.readouterr().out
    for heading in ("Available Frameworks:", "Available Controllers:",
                    "Available Tensor Operations:", "PyTorch",
                    "TCP (native", "NCCL", "Gloo", "nvcc"):
        assert heading in out
    assert TL.run_commandline(["--version"]) == 0
    assert capsys.readouterr().out.strip() == \
        __import__("horovod_tpu_torch").__version__


# --------------------------------------------------- the runtime's checks
@pytest.mark.parametrize("env,match", [
    ({"HOROVOD_KV_SHARDS": "0"}, "at least one shard"),
    ({"HOROVOD_KV_SHARDS": "2",
      "HOROVOD_KV_SHARD_ADDRS": "a:1,b:2,c:3"}, "must agree"),
    ({"HOROVOD_KV_SHARDS": "2", "HOROVOD_KV_SHARD_ADDRS": "a:1,b"},
     "host:port")])
def test_runtime_checks_kv_shard_knobs_at_init(monkeypatch, env, match):
    import horovod_tpu_torch as hvd
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def test_runtime_accepts_a_consistent_shard_map(monkeypatch):
    import horovod_tpu_torch as hvd
    monkeypatch.setenv("HOROVOD_KV_SHARDS", "2")
    monkeypatch.setenv("HOROVOD_KV_SHARD_ADDRS", "127.0.0.1:1,127.0.0.1:2")
    hvd.init(device="cpu")
    try:
        assert hvd.size() == 1
    finally:
        hvd.shutdown()
