"""The port's elastic state (``horovod_tpu_torch/elastic/state.py``,
``horovod_tpu_torch/torch/elastic.py``) against the JAX package's, in one
process on the CPU:

  * the same sequence of ``save``, ``commit``, ``restore``, host-update
    checks and reset callbacks gives the same scalars and the same
    exceptions on the JAX ``State`` and the port's;
  * the restore plan (which fast step, which store, which portable step)
    is a function of the ranks' views: a table of views gives the same
    ``(fast_step, use_fast, agreed_step)`` from ``JaxState`` and from
    ``TreeState`` (the JAX ``commit_format="orbax"`` is the port's
    ``"portable"``);
  * ``TorchState`` and ``ElasticSampler`` against the JAX torch
    frontend's on the same model, optimizer and data: the same snapshots
    and restores, and the same indices by world, epoch and processed
    count (as tests/test_torch.py:328-360)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402
import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.elastic import state as TS  # noqa: E402
from horovod_tpu_torch.torch import elastic as TE  # noqa: E402

SCRIPTS = {
    "save-restore": [("set", "epoch", 9), ("set", "batch", 99),
                     ("restore",), ("save",), ("set", "epoch", 3),
                     ("restore",)],
    "commit-then-host-update": [("commit",), ("set", "epoch", 7),
                                ("hosts", True), ("commit",),
                                ("set", "epoch", 11), ("restore",),
                                ("hosts", False), ("commit",)],
    "check-and-callbacks": [("callbacks",), ("hosts", True), ("check",),
                            ("on_reset",), ("hosts", False), ("check",),
                            ("on_reset",), ("set", "batch", 1),
                            ("commit",), ("restore",)],
    "restore-before-save": [("restore",), ("set", "epoch", 2), ("save",),
                            ("set", "epoch", 5), ("restore",)],
}


def _play(module, script):
    calls, flag = [], {"v": False}
    s = module.State(epoch=1, batch=5)
    s.register_host_update_check(lambda: flag["v"])
    trace = []
    for op in script:
        try:
            if op[0] == "set":
                setattr(s, op[1], op[2])
            elif op[0] == "hosts":
                flag["v"] = op[1]
            elif op[0] == "callbacks":
                s.register_reset_callbacks([lambda: calls.append("a"),
                                            lambda: calls.append("b")])
            elif op[0] == "check":
                s.check_host_updates()
            else:
                getattr(s, op[0])()
            outcome = None
        except Exception as e:  # the exception's class is the result
            outcome = type(e).__name__
        trace.append((op, outcome, s.epoch, s.batch, list(calls)))
    return trace


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_state_protocol_matches_jax(name):
    from horovod_tpu.elastic import state as JS
    assert _play(TS, SCRIPTS[name]) == _play(JS, SCRIPTS[name])


# ------------------------------------------------------ the restore plan
class _Fast:
    def __init__(self, steps):
        self._steps = dict(steps)

    def steps(self):
        return list(self._steps)

    def marker_mtime(self, s):
        return self._steps.get(s)


class _Mgr:
    def __init__(self, step, t):
        self.step, self.t = step, t

    def latest_step(self):
        return self.step

    def step_mtime(self, s):
        return self.t


# each row: every rank's view (fast steps {step: marker time}, portable
# step, its time); rank 0's view is the local one
VIEWS = {
    "agree-fast-only": [({0: 1.0, 1: 2.0}, None, None)] * 2,
    "markers-disagree": [({0: 1.0, 1: 2.0, 2: 3.0}, None, None),
                         ({0: 1.0, 1: 2.0}, None, None),
                         ({1: 2.5, 2: 3.5}, None, None)],
    "no-common-fast": [({0: 1.0}, None, None), ({1: 2.0}, None, None)],
    "portable-newer": [({3: 5.0}, 7, 9.0), ({3: 5.5}, 7, 8.0)],
    "fast-newer": [({3: 10.0}, 7, 9.0), ({3: 5.5}, 7, 8.0)],
    "portable-disagree": [({3: 5.0}, 7, 9.0), ({3: 5.5}, 6, 8.0)],
    "portable-missing-on-one": [({3: 5.0}, 7, 9.0), ({3: 5.5}, None, None)],
    "equal-times": [({4: 6.0}, 2, 6.0), ({4: 6.0}, 2, 6.0)],
    "only-portable": [({}, 5, 1.0), ({}, 5, 1.0)],
    "nothing": [({}, None, None)] * 3,
    "single-rank": [({0: 1.0, 5: 2.0}, 3, 1.5)],
}


def _jax_plan(monkeypatch, views, fmt):
    import jax
    from horovod_tpu import functions as JF
    from horovod_tpu.elastic.state import JaxState
    monkeypatch.setattr(jax, "process_count", lambda: len(views))
    monkeypatch.setattr(JF, "allgather_object", lambda local: list(views))
    s = JaxState(params=None, opt_state=None, sharded_commit_dir="/dev/null",
                 commit_format=fmt)
    monkeypatch.setattr(s, "_orbax_steps_may_exist",
                        lambda: views[0][1] is not None)
    monkeypatch.setattr(s, "_manager", lambda: _Mgr(views[0][1],
                                                    views[0][2]))
    return s._agreed_restore_plan(_Fast(views[0][0]))


def _port_plan(monkeypatch, views, fmt):
    s = TS.TreeState(params=None, opt_state=None,
                     sharded_commit_dir="/dev/null", commit_format=fmt)
    monkeypatch.setattr(s, "_portable_steps_may_exist",
                        lambda: views[0][1] is not None)
    monkeypatch.setattr(s, "_manager", lambda: _Mgr(views[0][1],
                                                    views[0][2]))
    monkeypatch.setattr(s, "_gather", lambda local: list(views))
    return s._agreed_restore_plan(_Fast(views[0][0]))


@pytest.mark.parametrize("fmt", ["fast", "portable"])
@pytest.mark.parametrize("name", sorted(VIEWS))
def test_restore_plan_matches_jax(monkeypatch, name, fmt):
    views = VIEWS[name]
    want = _jax_plan(monkeypatch, views,
                     "orbax" if fmt == "portable" else fmt)
    assert _port_plan(monkeypatch, views, fmt) == want
    assert TS.decide_restore_plan(views, fmt) == want


def test_commit_format_names():
    with pytest.raises(ValueError, match="portable"):
        TS.TreeState(params=None, commit_format="orbax")


# ------------------------------------- the eager frontend's elastic state
@pytest.fixture(scope="module")
def runtimes():
    import horovod_tpu
    horovod_tpu.init()
    rt = hvd.init(device="cpu")
    yield rt
    hvd.shutdown()


def _model_and_opt(kind):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    opt = (torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
           if kind == "sgd" else
           torch.optim.AdamW(model.parameters(), lr=0.1))
    model(torch.ones(2, 3)).sum().backward()
    opt.step()
    return model, opt


def _frozen(sd):
    if isinstance(sd, dict):
        return {k: _frozen(v) for k, v in sd.items()}
    if isinstance(sd, (list, tuple)):
        return type(sd)(_frozen(v) for v in sd)
    if torch.is_tensor(sd):
        return ("t", tuple(sd.shape), str(sd.dtype), sd.tolist())
    return sd


def _state_trace(mod, kind):
    model, opt = _model_and_opt(kind)
    s = mod.TorchState(model=model, optimizer=opt, epoch=3)
    s.sync()
    s.commit()
    at_commit = _frozen(model.state_dict()), _frozen(opt.state_dict())
    with torch.no_grad():
        model[0].weight.add_(1.0)
    model(torch.ones(2, 3)).sum().backward()
    opt.step()
    s.epoch = 7
    mid = _frozen(model.state_dict()), _frozen(opt.state_dict())
    s.restore()
    return (s.epoch, mid, _frozen(model.state_dict()),
            _frozen(opt.state_dict()), _frozen(s._snapshots["model"]),
            _frozen(s._snapshots["optimizer"])), at_commit


def test_torch_state_matches_the_jax_frontend(runtimes):
    """SGD with momentum: the JAX frontend's optimizer broadcast cannot
    take AdamW's 0-d step counts (its broadcast hands back shape [1]), so
    the comparison runs on a state with none."""
    from horovod_tpu.torch import elastic as JE
    port, _ = _state_trace(TE, "sgd")
    jax_, _ = _state_trace(JE, "sgd")
    assert port == jax_
    assert port[0] == 3


def test_torch_state_restores_adamw_to_the_commit(runtimes):
    got, at_commit = _state_trace(TE, "adamw")
    assert got[0] == 3
    assert (got[2], got[3]) == at_commit != got[1]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("world", [(1, 0), (4, 0), (4, 3), (3, 1)])
def test_elastic_sampler_matches_the_jax_frontend(monkeypatch, shuffle,
                                                  world):
    import horovod_tpu
    from horovod_tpu.torch import elastic as JE
    size, rank = world
    for mod in (horovod_tpu, hvd):
        monkeypatch.setattr(mod, "size", lambda: size)
        monkeypatch.setattr(mod, "rank", lambda: rank)
    data = list(range(23))
    seen = {}
    for name, mod in (("jax", JE), ("port", TE)):
        s = mod.ElasticSampler(data, shuffle=shuffle, seed=5)
        trace = [list(iter(s)), len(s)]
        s.record_batch(0, 2)
        s.record_batch(1, 2)
        trace.append(sorted(s.processed_indices))
        s.reset()
        trace += [list(iter(s)), sorted(s.remaining_indices)]
        s.set_epoch(2)
        trace += [list(iter(s)), s.num_samples]
        s.record_indices([1, 4, 9])
        sd = s.state_dict()
        s2 = mod.ElasticSampler(data, shuffle=shuffle, seed=5)
        s2.load_state_dict(sd)
        trace += [sd, list(iter(s2)), len(s2)]
        seen[name] = trace
    assert seen["port"] == seen["jax"]
