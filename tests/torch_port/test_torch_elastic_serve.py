"""Elastic serving on gloo ranks: the port's run of the JAX package's
tests/integration/test_elastic_serve_integration.py.

One experiment, two fleets of the same layout over the same servable (the
``tiny`` Llama on the JAX package's weights of ``PRNGKey(0)``), each
``launch --min-np 2 --max-np 2 --host-discovery-script S --serve DIR
--serve-device cpu`` with S printing ``localhost:2`` and ``127.0.0.1:2``,
as a subprocess in a session of its own with a hard deadline:

  * fleet A (unfaulted) serves the reference streams, which equal greedy
    decoding through the model, then drains: ``POST /admin/drain``
    answers 200 and the launcher exits 0;
  * fleet B serves the same requests under a seeded chaos spec that kills
    rank 0 on the engine's work-tick clock while tokens stream; the
    elastic driver resets the fleet, the new rank 0 redrives the
    journaled requests past their streamed prefix, and every client's
    ndjson stream completes byte-identical to fleet A's; fleet B drains
    and exits 0 too.

The JAX test kills rank 1.  The port's rank 1 follows rank 0's plan
stream through the rendezvous KV without waiting in a collective, and on
a loaded CPU it can trail rank 0 by more than the whole run, so a kill
at its tick 5 may land after every stream ended; rank 0 leads the
stream, so its tick 5 is mid-stream.  (The card's experiment,
``chip_smoke.py --ranks 4 --parts elastic`` (c), kills rank 1 a quarter
of the way through a run of about a hundred ticks.)  Prefix sharing and
speculative decoding are pinned on, as in the JAX test."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402
import signal  # noqa: E402
import stat  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
import urllib.request  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_port_ports import hold_ports  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PROMPTS = [[3, 14, 15, 92], [2, 7, 18, 28, 18]]
MAX_NEW = 10


def _servable(tmp_path):
    import jax
    from horovod_tpu.models import llama as JL
    from horovod_tpu_torch.models import llama as TL
    from horovod_tpu_torch.serve import engine as TE
    cfg = dataclasses.replace(TL.CONFIGS["tiny"], max_seq=64)
    model = TL.params_from_jax(
        jax.tree_util.tree_map(np.asarray,
                               JL.init(jax.random.PRNGKey(0),
                                       JL.CONFIGS["tiny"])), cfg,
        device="cpu")
    servable = str(tmp_path / "servable")
    TE.save_servable(servable, "llama", cfg, model)
    return servable, model


def _fleet(tmp_path, servable, port, tag, chaos_spec=None):
    disc = tmp_path / f"discover_{tag}.sh"
    disc.write_text("#!/bin/sh\necho 'localhost:2'\necho '127.0.0.1:2'\n")
    disc.chmod(disc.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1",
               CUDA_VISIBLE_DEVICES="", HOROVOD_SERVE_PREFIX_CACHE="1",
               HOROVOD_SERVE_SPEC="1", HOROVOD_SERVE_MAX_SEQ_LEN="64",
               HOROVOD_SERVE_CACHE_BLOCKS="64",
               HOROVOD_SERVE_MAX_BATCH_TOKENS="64")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.pop("HOROVOD_CHAOS_SPEC", None)
    coord, ctrl = hold_ports(2).release()
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
           "--min-np", "2", "--max-np", "2",
           "--host-discovery-script", str(disc), "--elastic-timeout", "60",
           "--coordinator-port", str(coord), "--controller-port", str(ctrl),
           "--serve", servable, "--serve-port", str(port),
           "--serve-ttl", "150", "--serve-device", "cpu"]
    if chaos_spec is not None:
        cmd += ["--chaos", chaos_spec]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=REPO, start_new_session=True)


def _wait_ready(proc, port, deadline_s=90):
    deadline = time.time() + deadline_s
    while time.time() < deadline and proc.poll() is None:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/serve/stats", timeout=5) as r:
                if "engine" in json.loads(r.read()):
                    return True
        except (OSError, ValueError):
            pass
        time.sleep(0.2)
    return False


def _post(port, tokens, out, idx):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"tokens": tokens,
                         "max_new_tokens": MAX_NEW}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=90) as r:
        out[idx] = [json.loads(ln) for ln in r.read().splitlines()]


def _streams(port):
    results = [None] * len(PROMPTS)
    threads = [threading.Thread(target=_post, args=(port, p, results, i))
               for i, p in enumerate(PROMPTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    out = []
    for lines in results:
        assert lines, "a request got no response"
        assert lines[-1].get("done") is True, lines
        out.append(([t for ln in lines[:-1] for t in ln["tokens"]],
                    lines[-1]["tokens"]))
    return out


def _drain_and_end(proc, port):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/admin/drain",
                                 data=b"{}", method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        status, body = r.status, json.loads(r.read())
    assert status == 200 and body["drained"] is True, body
    assert body["router"]["pending"] == 0, body
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, out[-4000:]
    return out


def _run_fleet(tmp_path, servable, tag, spec=None):
    port = hold_ports(1).release()[0]
    proc = _fleet(tmp_path, servable, port, tag, spec)
    try:
        assert _wait_ready(proc, port), f"fleet {tag} never ready"
        streams = _streams(port)
        return streams, _drain_and_end(proc, port)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()


def test_elastic_serve_kill_mid_stream_redrives_and_drains(tmp_path):
    servable, model = _servable(tmp_path)
    streams_a, _ = _run_fleet(tmp_path, servable, "a")
    for (parts, done), prompt in zip(streams_a, PROMPTS):
        ids = list(prompt)
        with torch.no_grad():
            for _ in range(MAX_NEW):
                ids.append(int(model(torch.tensor([ids]))[0, -1].argmax()))
        assert parts == done == ids[len(prompt):]

    state_dir = tmp_path / "chaos_state"
    spec = tmp_path / "chaos.json"
    spec.write_text(json.dumps({"seed": 23, "state_dir": str(state_dir),
                                "events": [{"kill": {"rank": 0,
                                                     "step": 5}}]}))
    streams_b, out_b = _run_fleet(tmp_path, servable, "b", str(spec))
    assert (state_dir / "chaos_fired_0_rank0").exists(), \
        "chaos kill never fired"
    # byte-identical to the unfaulted fleet: the acceptance claim
    assert streams_b == streams_a
    # the redrive machinery, not a lucky clean pass, carried fleet B
    assert "redriving" in out_b, out_b[-4000:]
    assert "elastic round 1" in out_b, out_b[-4000:]
