"""``launch --scenario`` on two gloo ranks through the port's launcher:
the two cases of ``tests/integration/test_scenario_integration.py``.
The spec is published at KV scope ``scenario`` as JSON and both ranks
regenerate the JAX package's event digest from it; its storm reaches the
ranks merged after the ``--chaos`` spec's events; its embedded alert rule
is in the published ruleset; a ``--chaos`` spec whose seed contradicts the
scenario's fails the launch before any rank starts.  Every port is a free
one; the worker is ``torch_port_scenario_worker.py``."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402
import re  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import pytest  # noqa: E402
from torch_port_ports import hold_ports  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_port_scenario_worker.py")

# tests/integration/test_scenario_integration.py's spec and chaos base
_SPEC = """
name: integration-smoke
seed: 11
virtual_ranks: 32
tick_ms: 10
phases:
  - name: steady
    kind: serve
    duration_s: 1.0
    arrivals: {process: poisson, rate: 15}
    shapes: {prompt_mean: 8, prompt_max: 24, output_mean: 4}
storm:
  - stall: {at_s: 0.5, duration_s: 0.05}
alert_rules:
  - name: scenario-smoke-rule
    family: hvd_scenario_queue_depth
    kind: threshold
    op: ">="
    value: 1e18
    severity: info
"""

_BASE_CHAOS = """
seed: 11
events:
  - stall: {rank: 0, step: 100000, point: complete, duration_ms: 1}
"""


def _launch(tmp_path, base_chaos, deadline=120):
    spec = tmp_path / "scenario.yaml"
    spec.write_text(_SPEC)
    base = tmp_path / "chaos.yaml"
    base.write_text(base_chaos)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    for name in ("HOROVOD_CHAOS_SPEC", "HOROVOD_ALERTS", "HOROVOD_SCENARIO"):
        env.pop(name, None)
    coord, ctrl = hold_ports(2).release()
    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "2", "--coordinator-port", str(coord), "--controller-port",
         str(ctrl), "--chaos", str(base), "--scenario", str(spec),
         sys.executable, WORKER],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    try:
        out, err = p.communicate(timeout=deadline)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        pytest.fail(f"the launch did not end in {deadline} s: "
                    f"{err.decode()[-4000:]}")
    return p.returncode, out.decode(), err.decode(), str(spec)


def test_scenario_spec_storm_and_rules_reach_every_rank(tmp_path):
    from horovod_tpu.scenario import (events_digest, generate_events,
                                      load_scenario)
    rc, out, err, spec_path = _launch(tmp_path, _BASE_CHAOS)
    assert rc == 0, out + err
    # markers can interleave on one line: match, don't split lines
    marks = re.findall(r"SCENARIO-KV-OK (\d) ([0-9a-f]{64})", out)
    assert sorted(r for r, _ in marks) == ["0", "1"], out + err
    spec = load_scenario(spec_path)
    want = events_digest(generate_events(spec.seed, spec.phases,
                                         spec.vocab))
    assert {d for _, d in marks} == {want}, marks


def test_scenario_storm_chaos_conflict_fails_launch(tmp_path):
    rc, out, err, _ = _launch(
        tmp_path, "seed: 99\nevents:\n  - stall: {rank: 0}\n")
    assert rc == 2, out + err
    assert "seed conflicts" in err
    assert "SCENARIO-KV-OK" not in out


def test_launcher_flags_match_jax(tmp_path):
    """``args_to_env`` and the merged chaos spec of ``--chaos`` +
    ``--scenario`` equal the JAX launcher's; the published spec is the
    JAX package's JSON."""
    from horovod_tpu.runner import launch as JL
    from horovod_tpu_torch.runner import launch as TL
    spec = tmp_path / "scenario.yaml"
    spec.write_text(_SPEC)
    base = tmp_path / "chaos.yaml"
    base.write_text(_BASE_CHAOS.replace(
        "events:", "transport: {drop_rate: 0.25}\nevents:"))
    for flags in (["--scenario", str(spec)],
                  ["--chaos", str(base), "--scenario", str(spec)]):
        argv = ["-np", "2"] + flags + ["python", "t.py"]
        jargs = JL.make_parser().parse_args(argv)
        targs = TL.make_parser().parse_args(argv)
        assert TL.refused_flag(targs) is None
        assert TL.args_to_env(targs) == JL.args_to_env(jargs)
        assert TL.args_to_env(targs)["HOROVOD_CHAOS"] == "1"
        assert TL.merged_chaos_spec(targs).to_json() == \
            JL.merged_chaos_spec(jargs).to_json()
        assert TL.load_scenario_spec(targs).to_json() == \
            JL.load_scenario_spec(jargs).to_json()


def test_scenario_rules_install_under_the_operators(tmp_path):
    """``install_alert_rules``: the spec's embedded rules join the
    operator's ``--alerts`` rules, an operator rule of the same name wins,
    and the set published at KV scope ``alerts`` is the JAX launcher's."""
    from horovod_tpu.runner import launch as JL
    from horovod_tpu.runner.http_server import RendezvousServer as JR
    from horovod_tpu_torch.runner import launch as TL
    from horovod_tpu_torch.runner.http_server import RendezvousServer as TR
    spec = tmp_path / "scenario.yaml"
    spec.write_text(_SPEC + """  - name: scenario-shadowed
    family: hvd_scenario_queue_depth
    kind: threshold
    op: ">="
    value: 5
    severity: info
""")
    rules = tmp_path / "rules.json"
    rules.write_text('{"rules": [{"name": "scenario-shadowed", "family": '
                     '"hvd_scenario_shed_total", "kind": "threshold", '
                     '"op": ">=", "value": 1, "severity": "warning"}]}')
    argv = ["-np", "2", "--alerts", str(rules), "--scenario", str(spec),
            "python", "t.py"]
    published = []
    for L, R in ((JL, JR), (TL, TR)):
        server = R()
        server.start()
        try:
            L.install_alert_rules(L.make_parser().parse_args(argv), server)
            published.append(server.get("alerts", "rules"))
        finally:
            server.stop()
    assert published[1] == published[0]
    got = {r["name"]: r for r in json.loads(published[1])["rules"]}
    assert "scenario-smoke-rule" in got and "straggler-suspect" in got
    assert got["scenario-shadowed"]["family"] == "hvd_scenario_shed_total"


def test_elastic_driver_publishes_the_scenario(tmp_path, monkeypatch):
    """``run_elastic`` (``--min-np``/``--max-np``) puts the spec, the merged
    chaos plan and the rules on its driver's rendezvous, as the static
    launch does, so every reset round reads them."""
    from horovod_tpu_torch.elastic import driver as D
    from horovod_tpu_torch.runner import launch as TL
    from horovod_tpu_torch.runner.http_server import RendezvousServer
    seen = {}

    class Driver:  # the elastic driver, stopped before its first round
        def __init__(self, *args, **kwargs):
            self.rendezvous = RendezvousServer()
            self.rdv_port = self.rendezvous.start()

        def run(self):
            try:
                for scope in ("scenario", "chaos"):
                    seen[scope] = json.loads(self.rendezvous.get(scope,
                                                                 "spec"))
                seen["rules"] = json.loads(self.rendezvous.get("alerts",
                                                               "rules"))
            finally:
                self.rendezvous.stop()
            return 0

    monkeypatch.setattr(D, "ElasticDriver", Driver)
    spec = tmp_path / "scenario.yaml"
    spec.write_text(_SPEC)
    disc = tmp_path / "discover.sh"
    disc.write_text("#!/bin/sh\necho localhost:1\n")
    disc.chmod(0o755)
    args = TL.make_parser().parse_args(
        ["--min-np", "1", "--max-np", "1", "--host-discovery-script",
         str(disc), "--scenario", str(spec), "python", "t.py"])
    assert D.run_elastic(args, ["python", "t.py"]) == 0
    assert seen["scenario"]["name"] == "integration-smoke"
    assert [(e["kind"], e["step"]) for e in seen["chaos"]["events"]] == \
        [("stall", 50)]
    assert "scenario-smoke-rule" in {r["name"] for r in seen["rules"]["rules"]}
