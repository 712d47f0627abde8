"""The port's serving fleet under its launcher (``python -m
horovod_tpu_torch.runner.launch``, run as a subprocess in a session of its
own with its own deadline, every port a free one, the workers asked for the
CPU):

* lockstep: ``-np 2`` gloo ranks of ``torch_port_serve_worker.py`` serve
  three requests in plan-stream lockstep, report identical tokens and
  scheduling digests, and give the JAX engine's tokens for the servable
  weights of the JAX fleet lockstep test
  (tests/integration/test_serve_integration.py:27-42);
* ``--serve DIR`` end to end, mixed and disaggregated: concurrent ``POST
  /generate`` streams carry full-forward greedy tokens, ``/serve/stats``
  answers, ``POST /admin/drain`` ends the fleet with exit code 0;
* no fallback: a worker with no card and no ``--device cpu`` fails at
  start-up;
* the launcher's serve flags, and ``checkpoint.py`` and the servable
  directory (the JAX ``tests/test_checkpoint.py`` cases that do not depend
  on orbax, and the JAX ``save_servable`` manifest)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
import urllib.request  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from horovod_tpu_torch import checkpoint as CK  # noqa: E402
from horovod_tpu_torch.models import llama as TL  # noqa: E402
from horovod_tpu_torch.runner import launch as TLN  # noqa: E402
from horovod_tpu_torch.serve import engine as TE  # noqa: E402

import torch_port_serve_worker as W  # noqa: E402
from torch_port_ports import hold_ports  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    """A port below the ephemeral range, free when taken (``hold_ports``)."""
    return hold_ports(1).release()[0]


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def _start(argv, env):
    return subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
         "--coordinator-port", str(_free_port()),
         "--controller-port", str(_free_port())] + argv,
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)


def _finish(p, deadline):
    """``(rc, stdout, stderr)``; at the deadline the launcher's session
    (its workers too) is killed and the test fails."""
    try:
        out, err = p.communicate(timeout=deadline)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        pytest.fail(f"the launch did not end in {deadline} s: "
                    f"{err.decode()[-3000:]}")
    return p.returncode, out.decode(), err.decode()


# -------------------------------------------------------------- lockstep
def test_fleet_lockstep_two_ranks_matches_the_jax_tokens(tmp_path):
    import jax
    from horovod_tpu.models import llama as JL
    from horovod_tpu.serve import engine as JE
    from horovod_tpu.serve.config import ServeConfig as JServeConfig
    cfg = JL.CONFIGS["tiny"]
    params = JL.init(jax.random.PRNGKey(3), cfg)  # the JAX test's seed 3
    model = TL.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               TL.CONFIGS["tiny"], device="cpu")
    servable = str(tmp_path / "servable")
    TE.save_servable(servable, "llama", TL.CONFIGS["tiny"], model)
    p = _start(["-np", "2", sys.executable, W.__file__],
               _env(SERVE_TEST_DIR=servable))
    rc, out, err = _finish(p, 110)
    assert rc == 0, err[-3000:]
    assert "CLIENT-OK" in out, out
    lines = [ln for ln in out.splitlines() if ln.startswith("SERVE-OK")]
    assert len(lines) == 2, out
    tokens = {json.dumps(json.loads(ln.split(" tokens ", 1)[1]
                                    .rsplit(" digest ", 1)[0]))
              for ln in lines}
    scheds = {ln.split(" sched ", 1)[1].split()[0] for ln in lines}
    assert len(tokens) == 1 and len(scheds) == 1, out
    got = dict(json.loads(tokens.pop()))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("hvd",))
    ref = JE.ServeEngine(JL, cfg, params, JServeConfig(
        max_slots=2, block_size=4, cache_blocks=32, max_seq_len=32,
        max_batch_tokens=16, prefill_chunk=8), mesh=mesh)
    reqs = [ref.submit([(7 * i + j) % cfg.vocab for j in range(5 + 2 * i)],
                       W.MAX_NEW, req_id=f"req.{i:06d}")
            for i in range(W.N_REQUESTS)]
    ref.flush()
    assert got == {r.req_id: r.out_tokens for r in reqs}


# ------------------------------------------------------- --serve DIR e2e
def _post(port, tokens, max_new, out, idx):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"tokens": tokens,
                         "max_new_tokens": max_new}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        out[idx] = [json.loads(ln) for ln in r.read().splitlines()]


@pytest.mark.parametrize("prefill_ranks", [0, 1])
def test_launch_serve_end_to_end(tmp_path, prefill_ranks):
    """``launch -np 2 --serve DIR --serve-device cpu``: mixed (two ranks
    in lockstep) and disaggregated (rank 0 prefills, rank 1 decodes, the
    KV crossing through ``serve_kv``)."""
    cfg = dataclasses.replace(TL.CONFIGS["tiny"], max_seq=64)
    model = TL.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    servable = str(tmp_path / "servable")
    TE.save_servable(servable, "llama", cfg, model)
    port = _free_port()
    p = _start(["-np", "2", "--serve", servable, "--serve-port", str(port),
                "--serve-ttl", "90", "--serve-device", "cpu"],
               _env(HOROVOD_SERVE_MAX_SEQ_LEN="64",
                    HOROVOD_SERVE_CACHE_BLOCKS="64",
                    HOROVOD_SERVE_MAX_BATCH_TOKENS="64",
                    HOROVOD_SERVE_PREFILL_RANKS=str(prefill_ranks)))
    try:
        deadline = time.time() + 60
        stats = {}
        while time.time() < deadline and "engine" not in stats:
            assert p.poll() is None, p.communicate()[1].decode()[-3000:]
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/serve/stats",
                        timeout=5) as r:
                    stats = json.loads(r.read())
            except OSError:
                pass
            time.sleep(0.1)
        assert "engine" in stats
        prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [5, 4, 3, 2, 1], [7] * 20]
        results = [None] * 3
        threads = [threading.Thread(target=_post,
                                    args=(port, pr, 8, results, i))
                   for i, pr in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for i, pr in enumerate(prompts):
            ids = list(pr)
            with torch.no_grad():
                for _ in range(8):
                    ids.append(int(model(torch.tensor([ids]))[0, -1]
                                   .argmax()))
            streamed = [t for ln in results[i][:-1] for t in ln["tokens"]]
            assert streamed == ids[len(pr):] == results[i][-1]["tokens"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/serve/stats",
                                    timeout=10) as r:
            stats = json.loads(r.read())
        assert stats["router"]["completed"] == 3
        assert stats["engine"]["role"] == ("decode" if prefill_ranks
                                           else "mixed")
        req = urllib.request.Request(f"http://127.0.0.1:{port}/admin/drain",
                                     data=b"{}", method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            ack = json.loads(r.read())
        assert ack["drained"] is True
        assert ack["engine_final"]["completed"] == 3
    except BaseException:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
        raise
    rc, out, err = _finish(p, 60)
    assert rc == 0, err[-3000:]
    done = [ln for ln in out.splitlines() if ln.startswith("SERVE-DONE")]
    assert len(done) == 2, out
    if prefill_ranks:
        assert any("role prefill" in ln for ln in done)
        assert any('"imports": 3' in ln for ln in done)
    else:
        assert len({ln.split("sched_digest ")[1].split()[0]
                    for ln in done}) == 1


def test_worker_without_a_card_or_cpu_request_fails_at_start(tmp_path):
    """No fallback: without a CUDA device and without ``--device cpu`` the
    worker exits nonzero at start-up, before it serves."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    servable = str(tmp_path / "servable")
    model = TL.init(TL.CONFIGS["tiny"], torch.Generator().manual_seed(0),
                    device="cpu")
    TE.save_servable(servable, "llama", TL.CONFIGS["tiny"], model)
    env = _env()
    for name in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORDINATOR_ADDR"):
        env.pop(name, None)
    p = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.serve.worker",
                        servable, "--ttl", "1"], cwd=REPO, env=env,
                       capture_output=True, timeout=100)
    assert p.returncode != 0
    assert b"device='cpu'" in p.stderr
    assert b"SERVE-READY" not in p.stdout


# --------------------------------------------------------- launcher flags
@pytest.mark.parametrize("dest", ["serve", "serve_port", "serve_ttl",
                                  "replicas", "replica_id"])
def test_serve_flags_are_no_longer_refused(dest):
    """The five flags the launcher refused until the fleet came parse and
    pass ``refused_flag``."""
    argv = {"serve": ["--serve", "d"], "serve_port": ["--serve-port", "7"],
            "serve_ttl": ["--serve-ttl", "2.5"],
            "replicas": ["--replicas", "2"],
            "replica_id": ["--replica-id", "1"]}[dest]
    args = TLN.make_parser().parse_args(argv)
    assert getattr(args, dest) is not None
    assert TLN.refused_flag(args) is None


def test_serve_port_command_and_env_match_the_jax_launcher(monkeypatch):
    from horovod_tpu.runner import launch as JLN
    for argv in (["--serve", "d"], ["--serve", "d", "--serve-port", "9"],
                 ["--serve", "d", "--serve-ttl", "30", "--replicas", "3",
                  "--replica-id", "2"], []):
        ta, ja = TLN.make_parser().parse_args(argv), \
            JLN.make_parser().parse_args(argv)
        assert TLN.resolve_serve_port(ta) == JLN.resolve_serve_port(ja)
        if argv:
            want = JLN.serve_worker_command(ja)
            want[2] = "horovod_tpu_torch.serve.worker"
            assert TLN.serve_worker_command(ta) == want
        tenv, jenv = TLN.args_to_env(ta), JLN.args_to_env(ja)
        for name in ("HOROVOD_SERVE_REPLICAS", "HOROVOD_SERVE_REPLICA_ID"):
            assert tenv.get(name) == jenv.get(name)
        # --serve turns on the metrics and heartbeat planes as the JAX
        # launcher does
        assert tenv.get("HOROVOD_METRICS") == jenv.get("HOROVOD_METRICS")
        assert tenv.get("HOROVOD_HEARTBEAT") == \
            jenv.get("HOROVOD_HEARTBEAT")
    monkeypatch.setenv("HOROVOD_SERVE_PORT", "4321")
    args = TLN.make_parser().parse_args(["--serve", "d"])
    assert TLN.resolve_serve_port(args) == 4321
    args = TLN.make_parser().parse_args(["--serve", "d", "--serve-device",
                                         "cpu"])
    assert TLN.serve_worker_command(args)[-2:] == ["--device", "cpu"]


def test_replica_fleets_join_replica_zeros_router(monkeypatch):
    """Replica 0's launch hosts the router; a launch with ``--replica-id``
    K > 0 points its workers at it (``--serve-port``, on the host
    HOROVOD_RENDEZVOUS_ADDR names, else this one)."""
    def join(argv):
        return TLN.serve_router_join(TLN.make_parser().parse_args(argv))
    monkeypatch.delenv("HOROVOD_RENDEZVOUS_ADDR", raising=False)
    monkeypatch.delenv("HOROVOD_SERVE_PORT", raising=False)
    base = ["--serve", "d", "--replicas", "2"]
    assert join(base + ["--replica-id", "0", "--serve-port", "9"]) is None
    assert join(["python", "t.py"]) is None
    assert join(base + ["--replica-id", "1", "--serve-port", "9"]) == \
        ("127.0.0.1", 9)
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_ADDR", "router-host")
    assert join(base + ["--replica-id", "1", "--serve-port", "9"]) == \
        ("router-host", 9)
    with pytest.raises(ValueError, match="--serve-port"):
        join(base + ["--replica-id", "1"])


@pytest.mark.parametrize("argv,needle", [
    (["--serve", "d", "--replicas", "2", "--replica-id", "1"],
     "give its port with --serve-port"),
    (["--serve", "d", "--replicas", "2", "--replica-id", "1",
      "--serve-port", "9", "--kv-shards", "2"], "that router's KV"),
    (["--serve", "d", "python", "x.py"], "supplies the worker command"),
    (["--serve", "d", "--replica-id", "1"], "needs --replicas"),
    (["--serve", "d", "--replicas", "2", "--replica-id", "2"],
     "out of range"),
    (["--serve-device", "cpu", "python"], "needs --serve")])
def test_serve_flag_errors_exit_2(argv, needle, capsys):
    assert TLN.run_commandline(["-np", "1"] + argv) == 2
    assert needle in capsys.readouterr().err


# ---------------------------------------------------------- checkpoint.py
def _state():
    return ({"w": torch.arange(32.0).reshape(8, 4), "b": torch.ones(4)},
            {"mu": torch.zeros(8, 4) + 0.5})


def test_checkpoint_save_restore_values_and_templates(tmp_path):
    params, opt_state = _state()
    mgr = CK.CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(0, params=params, opt_state=opt_state,
                    meta={"epoch": 3})
    tmpl_p = {k: torch.full_like(v, -1).double() for k, v in params.items()}
    out = mgr.restore(0, params=tmpl_p, opt_state=opt_state)
    assert torch.equal(out["params"]["w"].float(), params["w"])
    assert out["params"]["w"].dtype == torch.float64  # the template's
    assert torch.equal(out["opt_state"]["mu"], opt_state["mu"])
    assert out["meta"]["epoch"] == 3
    assert not mgr.save(0, params=params)  # an existing step stays
    assert mgr.save(0, params={"w": params["w"] * 2}, force=True)
    assert torch.equal(mgr.restore(0, params=params)["params"]["w"],
                       params["w"] * 2)


def test_checkpoint_latest_step_and_retention(tmp_path):
    params, _ = _state()
    mgr = CK.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.latest_step() is None
    for step in (0, 1, 2, 3):
        assert mgr.save(step, params=params, force=True)
    assert mgr.latest_step() == 3
    assert mgr.all_steps() == [2, 3]
    assert mgr.step_mtime(3) is not None and mgr.step_mtime(0) is None
    assert not any(n.startswith(".tmp") for n in os.listdir(mgr.directory))


def test_checkpoint_one_shot_helpers_and_missing(tmp_path):
    params, _ = _state()
    CK.save_checkpoint(str(tmp_path / "c"), 7, params=params,
                       meta={"note": "x"})
    out = CK.restore_checkpoint(str(tmp_path / "c"), params=params)
    assert torch.equal(out["params"]["w"], params["w"])
    assert out["meta"]["note"] == "x"
    with pytest.raises(FileNotFoundError):
        CK.CheckpointManager(str(tmp_path / "empty")).restore(params=params)
    with pytest.raises(FileNotFoundError):
        CK.restore_checkpoint(str(tmp_path / "c"), step=3, params=params)


def test_checkpoint_meta_types_and_no_meta(tmp_path):
    params, _ = _state()
    mgr = CK.CheckpointManager(str(tmp_path / "m"))
    mgr.save(0, params=params,
             meta={"epoch": np.int64(3), "shape": (4, 2), "lr": 1e-3})
    out = mgr.restore(0, params=params)
    assert out["meta"]["epoch"] == 3
    assert isinstance(out["meta"]["epoch"], np.int64)
    assert out["meta"]["shape"] == (4, 2)
    mgr.save(1, params=params)
    out = mgr.restore(1, params=params)
    assert "meta" not in out and torch.equal(out["params"]["b"],
                                             params["b"])


def test_servable_manifest_equals_the_jax_one_and_round_trips(tmp_path):
    """``serve.json`` is the JAX ``save_servable``'s record for the same
    config (its dtype dropped); ``load_servable`` gives the saved weights
    at their own dtype, a dtype name in the manifest wins, and a
    directory without a checkpoint serves a seeded init."""
    import jax
    from horovod_tpu.models import llama as JL
    from horovod_tpu.serve import engine as JE
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JE.save_servable(jdir, "llama", JL.CONFIGS["tiny"],
                     JL.init(jax.random.PRNGKey(0), JL.CONFIGS["tiny"]))
    model = TL.init(TL.CONFIGS["tiny"], torch.Generator().manual_seed(0),
                    device="cpu")
    TE.save_servable(tdir, "llama", TL.CONFIGS["tiny"], model)
    with open(os.path.join(jdir, "serve.json")) as f, \
            open(os.path.join(tdir, "serve.json")) as g:
        assert json.load(f) == json.load(g)
    module, cfg, loaded = TE.load_servable(tdir, device="cpu")
    assert module is TL and cfg.dtype == torch.float32
    for a, b in zip(model.state_dict().values(),
                    loaded.state_dict().values()):
        assert torch.equal(a, b)
    half = str(tmp_path / "half")
    TE.save_servable(half, "llama", TL.CONFIGS["tiny"],
                     {k: v.to(torch.bfloat16)
                      for k, v in model.state_dict().items()})
    _, cfg16, m16 = TE.load_servable(half, device="cpu")
    assert cfg16.dtype == m16.embed.table.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown"):
        TE.save_servable(str(tmp_path / "x"), "resnet", cfg, model)
    seeded = str(tmp_path / "seeded")
    os.makedirs(seeded)
    with open(os.path.join(seeded, "serve.json"), "w") as f:
        json.dump({"model": "moe_llama", "config": "tiny", "seed": 2}, f)
    module, mcfg, moe = TE.load_servable(seeded, device="cpu")
    assert type(moe).__name__ == "MoeLlama" and mcfg.n_experts == 4
    again = TE.load_servable(seeded, device="cpu")[2]
    for a, b in zip(moe.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    with open(os.path.join(seeded, "serve.json"), "w") as f:
        json.dump({"model": "llama", "config": dict(
            vocab=64, dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
            ffn_dim=64, max_seq=32, dtype="bfloat16")}, f)
    _, dcfg, dm = TE.load_servable(seeded, device="cpu")
    assert dcfg.dtype == dm.embed.table.dtype == torch.bfloat16


# ------------------------------------------------ chip_smoke's rehearsals
_REHEARSAL = """
import sys
import numpy as np
import torch
sys.path.insert(0, {repo!r})
import chip_smoke as C
from horovod_tpu_torch import serve
from horovod_tpu_torch.models import llama
llama.CONFIGS["1b"] = llama.LlamaConfig(
    vocab=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
    max_seq=1152, dtype=torch.bfloat16)
torch.cuda.memory_reserved = lambda *a: 0
# a loaded CPU publishes late: each read waits for what it counts
C.FLEET_SETTLE_S = C.FLEET_SCRAPE_S = C.FLEET_HEALTH_S = 90.0
ref = {{"ttft_p50": 1.0, "ttft_p99": 2.0, "tpot_p50": 0.5, "tok_s": 9.0}}
if {part!r} == "fleet":
    out = C.phase_fleet(torch, np, serve, "CPU", ref, device_type="cpu")
    assert out == {{name: 0 for name in C.REPLACES}}, out
else:
    C.SERVE_REQUESTS, C.SERVE_NEW_TOKENS = 8, 32
    C.rank_serve(torch, np, 4, "CPU", device_type="cpu")
print("REHEARSAL-OK", flush=True)
"""


@pytest.mark.parametrize("part", ["fleet", "serve"])
def test_chip_smoke_fleet_rehearsal_on_cpu(part):
    """``chip_smoke.py`` phase 14 (two ``-np 1`` fleets, fp32 and bf16,
    on the card's 16 requests) and the ``--ranks 4 --parts serve`` path
    (the disaggregated 2 + 2 fleet against one in-process engine, then
    two replica fleets of two ranks behind one router with replica 1
    killed mid-stream; 8 of the requests, 32 tokens each), with a narrow
    model of 1,152 positions standing in for ``1b`` and the workers on
    the CPU: every check of the card's run.  A replica is dark after 10 s
    without a heartbeat here (3 s on the card): a loaded CPU's tick can
    outlast 3 s.  The reads after the streams (the engines' stats, the
    scrape, the timeline) and the idle heartbeats wait up to 90 s for
    what they count (10, 30, 30 and 30 s on the card), and the rehearsal
    up to 300 s: 25-53 s alone or beside a six-worker run here, but it
    failed in the driver's loaded run."""
    p = subprocess.Popen([sys.executable, "-c", _REHEARSAL.format(
        repo=REPO, part=part)], cwd=REPO,
        env=_env(HOROVOD_SERVE_REPLICA_DEAD_S="10"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    rc, out, err = _finish(p, 300)
    assert rc == 0 and "REHEARSAL-OK" in out, (out[-3000:], err[-3000:])
    if part == "serve":
        assert out.count("8 of 8 streams byte-identical to one card's") == 2
        assert "handoffs 8 (prefill rank 0), imports 8" in out
        assert "replica 0 completed 8 requests and exited 0" in out
    else:
        assert out.count("byte-identical to full-forward greedy") == 1
