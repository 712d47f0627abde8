"""The port's launcher end to end on gloo ranks (``python -m
horovod_tpu_torch.runner.launch``, run as a subprocess with its own
deadline, in a session of its own so that a deadline ends its workers
too): two ``tiny`` Llama steps at ``-np 2`` against the JAX
data-parallel step on two CPU devices (``test_torch_data_parallel.py``'s
tolerances, rtol and atol 1e-5), the env and rendezvous slot each rank
gets, output capture, the fail-fast reap, and ``run(fn, np=2)``.  The
worker is ``torch_port_launch_worker.py``; every port is a free one."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import re  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402

import torch_port_launch_worker as W  # noqa: E402
from torch_port_ports import hold_ports  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OPT_KW = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-3, weight_decay=0.01)


def _free_port():
    """A port for a listener started right away (``run``'s store)."""
    return hold_ports(1).release()[0]


def _launch(argv, deadline=100):
    """``(rc, stdout, stderr)`` of one launch; at ``deadline`` the
    launcher's whole session (its workers too) is killed and the test
    fails."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    held = hold_ports(2)
    coord, ctrl = held.release()  # held until the spawn that binds them
    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
         "--coordinator-port", str(coord),
         "--controller-port", str(ctrl)] + argv,
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    try:
        out, err = p.communicate(timeout=deadline)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        pytest.fail(f"launch {argv} did not end in {deadline} s")
    return p.returncode, out.decode(), err.decode()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
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
    batches = [rng.randint(0, cfg.vocab, (4, 33)).astype(np.int32)
               for _ in range(2)]
    out_dir = str(tmp_path_factory.mktemp("launch"))
    np.save(os.path.join(out_dir, "inputs.npy"), np.array(
        {"tree": jax.tree_util.tree_map(np.asarray, params),
         "batches": batches, "opt_kw": OPT_KW}, dtype=object),
        allow_pickle=True)
    rc, _, err = _launch(["-np", "2", sys.executable, W.__file__, "train",
                          out_dir])
    assert rc == 0, err[-4000:]
    ranks = [np.load(os.path.join(out_dir, f"rank{r}.npy"),
                     allow_pickle=True).item() for r in range(2)]
    mesh = Mesh(np.array(jax.devices()[:2]), ("hvd",))
    opt = optax.adamw(OPT_KW["lr"], b1=0.9, b2=0.999, eps=OPT_KW["eps"],
                      weight_decay=OPT_KW["weight_decay"])
    step = make_train_step(lambda p, ids: JL.loss_fn(p, ids, cfg), opt, mesh,
                           donate=False)
    jp, js = replicate(params, mesh), replicate(opt.init(params), mesh)
    losses = []
    for b in batches:
        jp, js, loss = step(jp, js, shard_batch(jnp.asarray(b), mesh))
        losses.append(float(loss))
    return {"ranks": ranks, "jax_losses": losses,
            "jax_params": jax.tree_util.tree_map(np.asarray, jp)}


def test_launched_step_trains_like_jax(trained):
    from test_torch_llama import _jax_grads_as_torch  # same name mapping
    ref = _jax_grads_as_torch(trained["jax_params"])
    for r in trained["ranks"]:
        assert (r["rank"], r["size"]) in ((0, 2), (1, 2))
        np.testing.assert_allclose(r["losses"], trained["jax_losses"],
                                   rtol=1e-5, atol=1e-5)
        for name, p in r["params"].items():
            np.testing.assert_allclose(p, ref[name], rtol=1e-5, atol=1e-5,
                                       err_msg=name)


def test_launched_ranks_get_the_jax_launchers_env(trained):
    from horovod_tpu.runner.hosts import get_host_assignments, parse_hosts
    want = get_host_assignments(parse_hosts("localhost:2"), 2)
    for r, got in enumerate(trained["ranks"]):
        env = got["env"]
        assert {k: env[k] for k in want[r].to_env()} == want[r].to_env()
        assert got["slot"] == want[r].to_env()
        assert env["HOROVOD_RENDEZVOUS_ADDR"] == "127.0.0.1"
        assert int(env["HOROVOD_RENDEZVOUS_PORT"]) > 0
        host, port = env["HOROVOD_COORDINATOR_ADDR"].split(":")
        assert host == "127.0.0.1" and int(port) not in (29500, 29499)
        assert int(env["HOROVOD_CONTROLLER_PORT"]) not in (29500, 29499)


_STAMP = re.compile(r"^\[\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\.\d{3}\]<rank (\d)> ")


def test_output_filename_and_timestamp_prefix(tmp_path):
    script = ("import os, sys; r = os.environ['HOROVOD_RANK']; "
              "print('out', r); print('err', r, file=sys.stderr)")
    plain, stamped = str(tmp_path / "plain"), str(tmp_path / "stamped")
    rc, _, _ = _launch(["-np", "2", "--output-filename", plain,
                        sys.executable, "-c", script])
    assert rc == 0
    rc, _, _ = _launch(["-np", "2", "--output-filename", stamped,
                        "--prefix-output-with-timestamp",
                        sys.executable, "-c", script])
    assert rc == 0
    for r in range(2):
        for stream, word in (("stdout", "out"), ("stderr", "err")):
            with open(os.path.join(plain, f"rank.{r}", stream)) as f:
                assert f.read() == f"{word} {r}\n"
            with open(os.path.join(stamped, f"rank.{r}", stream)) as f:
                line = f.read()
            m = _STAMP.match(line)
            assert m and m.group(1) == str(r), line
            assert line[m.end():] == f"{word} {r}\n"
    rc, out, _ = _launch(["-np", "2", "--prefix-output-with-timestamp",
                          sys.executable, "-c", script])
    assert rc == 0
    lines = sorted(out.splitlines(), key=lambda ln: _STAMP.sub("", ln))
    assert [(_STAMP.match(ln).group(1), _STAMP.sub("", ln))
            for ln in lines] == [("0", "out 0"), ("1", "out 1")]


def test_fail_fast_returns_the_failing_rank_code(tmp_path):
    """Rank 1 exits 3 while rank 0 waits in a collective: the launcher
    returns 3 and rank 0 is gone within 20 s of rank 1's exit."""
    rc, _, err = _launch(["-np", "2", sys.executable, W.__file__, "fail",
                          str(tmp_path)], deadline=90)
    t_end = time.time()
    assert rc == 3, err[-4000:]
    with open(tmp_path / "rank1.exit") as f:
        t_exit = float(f.read())
    assert t_end - t_exit < 20.0
    with open(tmp_path / "rank0.pid") as f:
        pid = int(f.read())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)


def test_run_returns_results_in_rank_order():
    got = hvd.run(W.peer_info, args=("x",), np=2,
                  coordinator_port=_free_port())
    assert [g["rank"] for g in got] == [0, 1]
    assert [g["env_rank"] for g in got] == [0, 1]
    assert all(g["size"] == 2 and g["sum"] == 3.0 and g["tag"] == "x"
               for g in got)
    assert got[0]["pid"] != got[1]["pid"] != os.getpid()


def test_run_raises_with_the_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        hvd.run(W.divide, args=(0,), np=1, coordinator_port=_free_port())
    with pytest.raises(NotImplementedError):
        hvd.run(W.peer_info, args=("x",), hosts="otherhost:2")
    with pytest.raises(ValueError):
        hvd.run(W.peer_info, args=("x",), np=3, hosts="localhost:2")

