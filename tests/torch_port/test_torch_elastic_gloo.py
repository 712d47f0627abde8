"""The elastic plane end to end on gloo ranks, under the port's launcher
(``python -m horovod_tpu_torch.runner.launch --min-np --max-np
--host-discovery-script``, a subprocess in a session of its own with a
hard deadline that kills the whole launch): the experiments of the JAX
package's tests/integration/test_multiprocess.py (the reset round that
rebuilds the group, the 3 -> 2 -> 3 walk) and
tests/integration/test_chaos_integration.py (a chaos kill recovered, the
torn commit never restored), on the ``tiny`` Llama through the root
``DistributedOptimizer`` with ``flash_attention``'s plain path:

  * an unfaulted elastic launch, whose losses match the JAX
    ``make_train_step`` on the same weights and batches (rtol and atol
    1e-5, ``test_torch_data_parallel.py``'s tolerance);
  * a chaos kill of rank 1 after step 4 (two steps after the commit of
    step 2): the driver blacklists the alias, round 1 runs on the other,
    restores the commit of step 2 on every rank, and its losses are
    bitwise the unfaulted launch's;
  * rank 0 crashing between the data and the marker of its second
    commit: round 1 restores the first, no rank reads the torn one, and
    commits go on past it;
  * a ``HorovodInternalError`` reset in process (``-np 2``, no driver):
    shutdown, init, the in-memory restore; the next collectives run on
    the new group and the losses are bitwise the unfaulted launch's.

The worker is ``torch_port_elastic_worker.py``; ports are held until the
spawn (``torch_port_ports.py``)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402
import signal  # noqa: E402
import stat  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from torch_port_ports import hold_ports  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_port_elastic_worker.py")
OPT_KW = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-3, weight_decay=0.01)
STEPS = 8
ROWS = 4  # global rows a step: 2 a rank


def _discovery(d, lines, name="discover.sh"):
    path = os.path.join(d, name)
    with open(path, "w") as f:
        f.write("#!/bin/sh\n" + "".join(f"echo '{ln}'\n" for ln in lines))
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return path


def launch(argv, deadline=120, env_extra=None):
    """``(rc, stdout, stderr)`` of one launch with held coordinator and
    controller ports; at ``deadline`` the launcher's whole session is
    killed and the test fails."""
    # the gloo ranks use no card: hidden, so the driver's alias rule
    # (elastic/driver.py) has no cards to guard on a card machine either
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1",
               CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    for name in ("HOROVOD_CHAOS_SPEC", "HOROVOD_POSTMORTEM_DIR"):
        env.pop(name, None)
    coord, ctrl = hold_ports(2).release()
    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
         "--coordinator-port", str(coord), "--controller-port", str(ctrl)]
        + argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = p.communicate(timeout=deadline)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        pytest.fail(f"launch {argv} did not end in {deadline} s:\n"
                    + err.decode()[-4000:])
    return p.returncode, out.decode(), err.decode()


def _records(d, rank):
    with open(os.path.join(d, f"log.rank{rank}.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _losses(recs, rnd=None):
    return {r["step"]: r["loss"] for r in recs
            if r["kind"] == "step" and (rnd is None or r["round"] == rnd)}


def _elastic(d, spec=None, n=2):
    disc = _discovery(d, [f"localhost:{n}", f"127.0.0.1:{n}"])
    argv = ["--min-np", str(n), "--max-np", str(n),
            "--host-discovery-script", disc, "--elastic-timeout", "60"]
    if spec is not None:
        path = os.path.join(d, "chaos.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        argv += ["--chaos", path]
    return launch(argv + [sys.executable, WORKER, "train", d])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh
    from horovod_tpu.models import llama as JL
    from horovod_tpu.parallel.data_parallel import (make_train_step,
                                                    replicate, shard_batch)
    cfg = JL.CONFIGS["tiny"]
    params = JL.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, cfg.vocab, (ROWS, 33)).astype(np.int32)
               for _ in range(STEPS)]
    inputs = np.array({"tree": jax.tree_util.tree_map(np.asarray, params),
                       "batches": batches, "opt_kw": OPT_KW}, dtype=object)
    out = {}
    dirs = {name: str(tmp_path_factory.mktemp(name)) for name in
            ("clean", "kill", "torn", "internal")}
    for d in dirs.values():
        np.save(os.path.join(d, "inputs.npy"), inputs, allow_pickle=True)
    out["clean"] = _elastic(dirs["clean"])
    out["kill"] = _elastic(dirs["kill"], spec={
        "seed": 11, "state_dir": os.path.join(dirs["kill"], "chaos_state"),
        "events": [{"kill": {"rank": 1, "step": 4}}]})
    out["torn"] = _elastic(dirs["torn"], spec={
        "seed": 13, "state_dir": os.path.join(dirs["torn"], "chaos_state"),
        "events": [{"crash_commit": {"rank": 0, "step": 1,
                                     "point": "pre_marker"}}]})
    out["internal"] = launch(["-np", "2", sys.executable, WORKER,
                              "internal", dirs["internal"]])
    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    opt = optax.adamw(OPT_KW["lr"], b1=0.9, b2=0.999, eps=OPT_KW["eps"],
                      weight_decay=OPT_KW["weight_decay"])
    step = make_train_step(lambda p, ids: JL.loss_fn(p, ids, cfg), opt, mesh,
                           donate=False)
    jp, js = replicate(params, mesh), replicate(opt.init(params), mesh)
    jax_losses = []
    for b in batches:
        jp, js, loss = step(jp, js, shard_batch(jnp.asarray(b), mesh))
        jax_losses.append(float(loss))
    return {"rc": out, "dirs": dirs, "jax_losses": jax_losses}


def _ok(runs, name):
    rc, out, err = runs["rc"][name]
    assert rc == 0, (out + err)[-4000:]
    return out + err


def test_unfaulted_elastic_launch_trains_like_jax(runs):
    _ok(runs, "clean")
    for rank in (0, 1):
        recs = _records(runs["dirs"]["clean"], rank)
        assert {r["round"] for r in recs} == {0}
        losses = _losses(recs)
        np.testing.assert_allclose([losses[i] for i in range(STEPS)],
                                   runs["jax_losses"], rtol=1e-5, atol=1e-5)
        end = recs[-1]
        assert end["kind"] == "end" and end["commits"] == [1, 2]


def test_failure_makes_a_reset_round_that_rebuilds_the_group(runs):
    log = _ok(runs, "kill")
    assert "elastic round 1" in log and "elastic round 2" not in log
    assert os.path.exists(os.path.join(runs["dirs"]["kill"], "chaos_state",
                                       "chaos_fired_0_rank1"))
    # the failing rank's alias is blacklisted: round 1 on the other
    assert "host blacklisted" in log
    for rank in (0, 1):
        starts = [r for r in _records(runs["dirs"]["kill"], rank)
                  if r["kind"] == "start"]
        assert [s["round"] for s in starts] == [0, 1]
        assert all(s["size"] == 2 for s in starts)


def test_chaos_kill_restores_the_last_commit_bitwise(runs):
    _ok(runs, "kill")
    clean = _losses(_records(runs["dirs"]["clean"], 0))
    ends = []
    for rank in (0, 1):
        recs = _records(runs["dirs"]["kill"], rank)
        start = [r for r in recs if r["kind"] == "start" and r["round"] == 1]
        # the commit of step 2 (store step 0) on every rank, never a cold
        # start
        assert start[0]["restored"] == {"format": "fast", "step": 0}
        assert start[0]["step"] == 2
        after = _losses(recs, rnd=1)
        assert sorted(after) == list(range(2, STEPS))
        assert all(after[i] == clean[i] for i in after), (after, clean)
        before = _losses(recs, rnd=0)
        assert all(before[i] == clean[i] for i in before)
        ends.append(recs[-1]["checksum"])
    assert ends[0] == ends[1]


def test_torn_commit_is_never_restored(runs):
    log = _ok(runs, "torn")
    d = runs["dirs"]["torn"]
    assert os.path.exists(os.path.join(d, "chaos_state",
                                       "chaos_fired_0_rank0"))
    assert "elastic round 1" in log
    clean = _losses(_records(runs["dirs"]["clean"], 0))
    for rank in (0, 1):
        recs = _records(d, rank)
        start = [r for r in recs if r["kind"] == "start" and r["round"] == 1]
        assert start, recs
        # rank 0 crashed before the marker of store step 1: it never holds
        # it, and every rank restores step 0, the commit before it
        if rank == 0:
            assert 1 not in start[0]["own_steps"]
        assert start[0]["restored"] == {"format": "fast", "step": 0}
        after = _losses(recs, rnd=1)
        assert all(after[i] == clean[i] for i in after)
        # commits go on past the torn step
        assert recs[-1]["commits"] == [1, 2]


def test_internal_error_resets_in_process(runs):
    _ok(runs, "internal")
    clean = _losses(_records(runs["dirs"]["clean"], 0))
    for rank in (0, 1):
        recs = _records(runs["dirs"]["internal"], rank)
        steps = [(r["step"], r["inc"]) for r in recs if r["kind"] == "step"]
        # steps 0-3, then the rollback to the commit of step 2 and on
        assert steps == [(0, 0), (1, 0), (2, 0), (3, 0)] + [
            (i, 1) for i in range(2, STEPS)]
        assert all(r["loss"] == clean[r["step"]] for r in recs
                   if r["kind"] == "step")
        assert recs[-1]["new_runtime"] is True


def test_membership_walk_3_2_3(tmp_path):
    hosts = tmp_path / "hosts.txt"
    hosts.write_text("localhost:1\n127.0.0.1:1\n127.0.0.2:1\n")
    disc = tmp_path / "discover.sh"
    disc.write_text(f"#!/bin/sh\ncat {hosts}\n")
    disc.chmod(disc.stat().st_mode | stat.S_IEXEC)
    rc, out, err = launch(["--min-np", "2", "--max-np", "3",
                           "--host-discovery-script", str(disc),
                           "--elastic-timeout", "60",
                           sys.executable, WORKER, "walk", str(tmp_path)],
                          deadline=150)
    assert rc == 0, (out + err)[-4000:]
    assert (tmp_path / "failed_once").exists(), "failure never injected"
    assert (tmp_path / "grew").exists(), "host set never grew"
    hosts_seen = {(tmp_path / f"walk_ok_{r}").read_text() for r in range(3)}
    # rank 2 of round 0 sat on the last host in name order, localhost: it
    # failed and stays blacklisted, and the grown host took its place
    assert hosts_seen == {"127.0.0.1", "127.0.0.2", "127.0.0.3"}
