"""Elastic state: the commit/restore/sync protocol; the port of
``horovod_tpu/elastic/state.py``.

Mirrors the reference's elastic State machinery (reference:
horovod/common/elastic.py:99-150 State.save/restore/commit/sync;
torch/elastic/state.py:27-140 per-type handlers): user state (parameters,
optimizer state, epoch/batch counters) is snapshotted on ``commit()``,
restored after a hard reset, and broadcast from the new rank 0 on
``sync()`` so late joiners converge.

A lost card on NCCL leaves the surviving ranks blocked in a collective,
not raising, so on the card a hard reset is a process restart by the
elastic driver (``elastic/driver.py``), as on the TPU: state then survives
through a durable commit (``sharded_commit_dir``, or the ``commit_path``
pickle) that the new round's ``load_from_disk`` restores.

``TreeState`` is the counterpart of the JAX package's ``JaxState``; its
portable commit format is ``checkpoint.CheckpointManager`` under the name
``"portable"`` where the JAX package names orbax (``"orbax"``).
"""

from __future__ import annotations

import copy
import os
import pickle
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..common.exceptions import HostsUpdatedInterrupt
from ..utils import metrics as _metrics
from .fastcommit import flatten, unflatten


class State:
    """Base elastic state (reference: common/elastic.py:99-150)."""

    def __init__(self, **kwargs: Any):
        self._saved: Dict[str, Any] = {}
        self._host_updated: Callable[[], bool] = lambda: False
        self._reset_callbacks: list = []
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._fields = list(kwargs.keys())

    # -- reset plumbing -----------------------------------------------------
    def register_host_update_check(self, fn: Callable[[], bool]) -> None:
        self._host_updated = fn

    def register_reset_callbacks(self, callbacks) -> None:
        """Callbacks invoked after every elastic reset, before training
        resumes (the canonical use is rescaling the LR to the new world
        size)."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        """Run the registered reset callbacks (called by the ``run``
        wrapper after a hard or soft reset)."""
        for cb in self._reset_callbacks:
            cb()

    def check_host_updates(self) -> None:
        """Raise HostsUpdatedInterrupt when membership changed (reference:
        common/elastic.py:60-97)."""
        if self._host_updated():
            raise HostsUpdatedInterrupt()

    # -- snapshot protocol --------------------------------------------------
    def save(self) -> None:
        for f in self._fields:
            self._saved[f] = copy.deepcopy(getattr(self, f))

    def restore(self) -> None:
        _metrics.ELASTIC_RESTORES.inc()
        for f, v in self._saved.items():
            setattr(self, f, copy.deepcopy(v))

    def commit(self) -> None:
        """Snapshot, then the host-update check (reference:
        common/elastic.py:118-131)."""
        t0 = time.monotonic()
        self.save()
        self.on_commit()
        _metrics.ELASTIC_COMMITS.inc()
        _metrics.ELASTIC_COMMIT_DURATION.observe(time.monotonic() - t0)
        self.check_host_updates()

    def on_commit(self) -> None:
        """Hook for subclasses (disk persistence)."""

    def sync(self) -> None:
        """Broadcast state from rank 0 so all workers agree.  The base
        class has nothing to broadcast but must still snapshot: a hard
        reset right after sync() rolls back to this point."""
        self.save()


class ObjectState(State):
    """Arbitrary picklable attributes, synced via broadcast_object
    (reference: horovod/common/elastic.py ObjectState)."""

    def sync(self) -> None:
        from ..functions import broadcast_object
        values = {f: getattr(self, f) for f in self._fields}
        values = broadcast_object(values, root_rank=0)
        for f, v in values.items():
            setattr(self, f, v)
        self.save()


def _world_size() -> int:
    from .. import runtime as _rt
    return _rt.get().size() if _rt.is_initialized() else 1


def _tensor_leaves(tree: Any):
    return [t for t in flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _clone_tree(tree: Any) -> Any:
    """A snapshot of a tree: its tensors cloned on their devices, the
    other leaves deep-copied."""
    if tree is None:
        return None
    leaves, treedef = flatten(tree)
    return unflatten(treedef, [
        t.detach().clone() if isinstance(t, torch.Tensor)
        else copy.deepcopy(t) for t in leaves])


class TreeState(State):
    """Elastic state of a training loop's parameters and optimizer state
    plus scalars: the counterpart of the JAX package's ``JaxState``.

    ``params`` and ``opt_state`` are trees of tensors (a model's
    ``state_dict()``, an optimizer's ``state_dict()``, or any nest of
    dicts, lists and tuples of tensors), or an ``nn.Module`` /
    ``torch.optim.Optimizer``, which go through ``state_dict()`` and
    ``load_state_dict()``.  Every restore copies into the live template
    tensors, so a model built on them sees the restored values.  Sync is
    leaf-wise broadcast from rank 0 over the process group (the root
    package's ``functions``), scalars through ``broadcast_object``.

    An optimizer that has not stepped has no state, and so is no template
    for a commit that has: ``load_from_disk`` creates it first
    (``functions.create_optimizer_state``) without moving the parameters,
    and takes it away again when nothing was restored.  ``sync`` follows
    rank 0: a rank whose optimizer lacks the state rank 0 holds creates
    it, and one that holds state rank 0 lacks drops it.
    """

    PYTREE_FIELDS = ("params", "opt_state")

    def __init__(self, params: Any = None, opt_state: Any = None,
                 commit_path: Optional[str] = None,
                 sharded_commit_dir: Optional[str] = None,
                 commit_format: str = "fast", **scalars: Any):
        self.commit_path = commit_path
        # "fast": raw per-rank blobs (fastcommit.py), restoring at disk
        # speed for the same-layout restart; "portable": the
        # CheckpointManager layout, readable after layout changes too
        self.sharded_commit_dir = sharded_commit_dir
        if commit_format not in ("fast", "portable"):
            raise ValueError(f"unknown commit_format {commit_format!r}: "
                             "use 'fast' or 'portable'")
        self.commit_format = commit_format
        self._ckpt_mgr = None
        self._fast_store = None
        self._commit_step = 0
        self.last_commit_bytes = 0
        # what load_from_disk restored: {"format": "fast" | "portable" |
        # "pickle", "step": the store's step}, or None
        self.last_restore: Optional[Dict[str, Any]] = None
        super().__init__(params=params, opt_state=opt_state, **scalars)

    # -- trees --------------------------------------------------------------
    def _tree(self, name: str) -> Any:
        """The live tree of a field: a module's or optimizer's state dict
        (whose tensors alias the live ones), else the field itself."""
        v = getattr(self, name)
        if isinstance(v, (torch.nn.Module, torch.optim.Optimizer)):
            return v.state_dict()
        return v

    def _scalars(self) -> Dict[str, Any]:
        return {f: getattr(self, f) for f in self._fields
                if f not in self.PYTREE_FIELDS}

    @torch.no_grad()
    def _apply(self, name: str, value: Any) -> None:
        """Copy a restored tree into the live templates of a field."""
        live = getattr(self, name)
        if live is None or value is None:
            if not isinstance(live, (torch.nn.Module,
                                     torch.optim.Optimizer)):
                setattr(self, name, value)
            return
        tmpl_leaves, treedef = flatten(self._tree(name))
        new_leaves = flatten(value)[0]
        merged = []
        for t, v in zip(tmpl_leaves, new_leaves):
            if isinstance(t, torch.Tensor):
                t.copy_(v)
                merged.append(t)
            else:
                merged.append(v)
        tree = unflatten(treedef, merged)
        if isinstance(live, torch.optim.Optimizer):
            # the state tensors were copied in place; this brings back the
            # rest (param_groups' hyperparameters, plain state entries)
            live.load_state_dict(tree)
        elif not isinstance(live, torch.nn.Module):
            setattr(self, name, tree)

    def _optimizers(self):
        return [getattr(self, n) for n in self.PYTREE_FIELDS
                if isinstance(getattr(self, n), torch.optim.Optimizer)]

    @torch.no_grad()
    def _create_opt_state(self, optimizers=None) -> list:
        """Give each stateless optimizer (of ``optimizers``, default all
        of this state's) its state without moving its parameters; the
        optimizers it created state for."""
        from ..functions import create_optimizer_state
        made = []
        for opt in self._optimizers() if optimizers is None else optimizers:
            if opt.state:
                continue
            params = [p for g in opt.param_groups for p in g["params"]]
            kept = [p.detach().clone() for p in params]
            create_optimizer_state(opt)
            for p, k in zip(params, kept):
                p.copy_(k)
            made.append(opt)
        return made

    # -- snapshot protocol --------------------------------------------------
    def save(self) -> None:
        for f in self._fields:
            if f in self.PYTREE_FIELDS:
                self._saved[f] = _clone_tree(self._tree(f))
            else:
                self._saved[f] = copy.deepcopy(getattr(self, f))

    def restore(self) -> None:
        _metrics.ELASTIC_RESTORES.inc()
        for f, v in self._saved.items():
            if f in self.PYTREE_FIELDS:
                self._apply(f, v)
            else:
                setattr(self, f, copy.deepcopy(v))

    @torch.no_grad()
    def sync(self) -> None:
        from ..functions import (_broadcast_any_device, broadcast_object,
                                 broadcast_optimizer_state)
        if _world_size() > 1:
            opts = self._optimizers()
            if opts:
                root_has = broadcast_object([bool(o.state) for o in opts],
                                            root_rank=0)
                for o, has in zip(opts, root_has):
                    if not has:
                        o.state.clear()
                self._create_opt_state(
                    [o for o, has in zip(opts, root_has) if has])
            # optimizer state first: creating it must not leave the
            # parameters apart from rank 0's
            for name in reversed(self.PYTREE_FIELDS):
                live = getattr(self, name)
                if isinstance(live, torch.optim.Optimizer):
                    if live.state:
                        broadcast_optimizer_state(live, root_rank=0)
                    continue
                if live is None:
                    continue
                leaves, treedef = flatten(self._tree(name))
                for t in leaves:
                    if isinstance(t, torch.Tensor):
                        _broadcast_any_device(t, 0)
                plain = [v for v in leaves if not isinstance(v, torch.Tensor)]
                if plain and not isinstance(live, torch.nn.Module):
                    it = iter(broadcast_object(plain, root_rank=0))
                    setattr(self, name, unflatten(treedef, [
                        v if isinstance(v, torch.Tensor) else next(it)
                        for v in leaves]))
            scalars = self._scalars()
            if scalars:
                synced = broadcast_object(scalars, root_rank=0)
                for k, v in synced.items():
                    setattr(self, k, v)
        self.save()

    # -- durable commits ----------------------------------------------------
    def _manager(self):
        if self._ckpt_mgr is None:
            from ..checkpoint import CheckpointManager
            self._ckpt_mgr = CheckpointManager(self.sharded_commit_dir,
                                               max_to_keep=2)
        return self._ckpt_mgr

    def _fast(self):
        if self._fast_store is None:
            from .fastcommit import FastCommitStore
            # a subdir: the portable manager scans sharded_commit_dir for
            # ITS step layout and must not trip over the step_N dirs
            self._fast_store = FastCommitStore(
                os.path.join(self.sharded_commit_dir, "fastcommit"),
                max_to_keep=2)
        return self._fast_store

    def _portable_steps_may_exist(self) -> bool:
        """Cheap listdir check for the portable store's numeric step
        dirs."""
        try:
            return any(n.split(".")[0].isdigit()
                       for n in os.listdir(self.sharded_commit_dir))
        except OSError:
            return False

    def _gather(self, local: Any) -> list:
        if _world_size() > 1:
            from ..functions import allgather_object
            return allgather_object(local)
        return [local]

    def _agreed_restore_plan(self, fast):
        """``(fast_step, use_fast, agreed_portable_step)``, decided from
        the SAME data on every rank, in ONE gather.

        The agreed fast step is the newest commit EVERY rank holds (a
        mid-commit preemption leaves the ranks' markers apart); a portable
        store the ranks DISAGREE about is unusable; between the stores the
        newest commit wins by the latest time any rank observed, exact
        ties breaking toward the configured commit_format."""
        own_steps = {s: fast.marker_mtime(s) for s in fast.steps()}
        port_step = port_t = None
        if self._portable_steps_may_exist():
            mgr = self._manager()
            port_step = mgr.latest_step()
            port_t = (mgr.step_mtime(port_step)
                      if port_step is not None else None)
        views = self._gather((own_steps, port_step, port_t))
        return decide_restore_plan(views, self.commit_format)

    def on_commit(self) -> None:
        if self.sharded_commit_dir:
            scalars = self._scalars()
            trees = {n: self._tree(n) for n in self.PYTREE_FIELDS}
            if self.commit_format == "fast":
                # durable on return (tmp+rename+marker inside)
                self.last_commit_bytes = self._fast().save(
                    self._commit_step, trees, meta=scalars)
            else:
                self._manager().save(self._commit_step, meta=scalars,
                                     force=True, **trees)
                self.last_commit_bytes = sum(
                    t.numel() * t.element_size()
                    for tree in trees.values()
                    for t in _tensor_leaves(tree))
            self._commit_step += 1
        if self.commit_path:
            tmp = self.commit_path + ".tmp"
            host_state = {}
            for f in self._fields:
                v = self._tree(f) if f in self.PYTREE_FIELDS \
                    else getattr(self, f)
                if v is not None and f in self.PYTREE_FIELDS:
                    leaves, treedef = flatten(v)
                    v = unflatten(treedef, [
                        t.detach().cpu() if isinstance(t, torch.Tensor)
                        else t for t in leaves])
                host_state[f] = v
            with open(tmp, "wb") as fh:
                pickle.dump(host_state, fh)
            os.replace(tmp, self.commit_path)

    def _all_ranks_agree(self, ok: bool) -> bool:
        """All or nothing on a local outcome: one rank restoring while a
        peer fails would diverge the parameters and hang the next
        collective."""
        return all(self._gather(bool(ok)))

    def _apply_restored(self, out: Dict[str, Any], step: int,
                        how: str) -> None:
        self.last_restore = {"format": how, "step": step}
        for name in self.PYTREE_FIELDS:
            if out.get(name) is not None:
                self._apply(name, out[name])
        for k, v in (out.get("meta") or {}).items():
            setattr(self, k, v)
        self._commit_step = step + 1
        self.save()

    def _templates(self) -> Dict[str, Any]:
        return {n: self._tree(n) for n in self.PYTREE_FIELDS}

    def _restore_fast(self, fast, step: int) -> bool:
        out = fast.restore(step, self._templates())
        if out is None:
            from ..common import hvdlogging as log
            log.warning("elastic: fast commit step %d does not map onto this "
                        "state's templates (world size, leaves, shapes, "
                        "dtypes or devices changed) or cannot be read",
                        step)
        if not self._all_ranks_agree(out is not None):
            return False
        self._apply_restored(out, step, "fast")
        return True

    def _restore_portable(self, step: int) -> bool:
        tmpl = self._templates()
        try:
            out = self._manager().restore(step, **tmpl)
        except Exception:
            out = None
        # the portable reader maps values onto any template: a commit of
        # another layout must fail the load here, as in the fast store
        if out is not None and not all(
                tree_matches_template(tmpl[n], out.get(n))
                for n in self.PYTREE_FIELDS):
            out = None
        if not self._all_ranks_agree(out is not None):
            return False
        self._apply_restored(out, step, "portable")
        return True

    def load_from_disk(self) -> bool:
        """Restore a commit written by a previous incarnation of this
        process (the restart path).  The current params/opt_state are the
        restore templates (structure, shapes, dtypes, devices).

        Precedence: the NEWEST durable commit wins, judged by commit
        wall-clock across both stores (step counters restart per
        incarnation).  If that newest commit cannot be restored (a fast
        commit after a layout or dtype change), load_from_disk does NOT
        fall back to an older commit: it returns False and the caller
        decides (the ``commit_path`` pickle, consulted last, carries the
        same commit freshness)."""
        made = self._create_opt_state()
        ok = self._load_from_disk()
        if not ok:
            for opt in made:
                opt.state.clear()
        return ok

    def _load_from_disk(self) -> bool:
        if self.sharded_commit_dir:
            fast = self._fast()
            fast_step, use_fast, agreed_port = \
                self._agreed_restore_plan(fast)
            if use_fast:
                if self._restore_fast(fast, fast_step):
                    return True
                # the newest commit is unrestorable: older portable steps
                # stay off-limits; only the pickle below may still serve
            elif agreed_port is not None:
                if self._restore_portable(agreed_port):
                    return True
        host_state = None
        if self.commit_path and os.path.exists(self.commit_path):
            try:
                with open(self.commit_path, "rb") as fh:
                    host_state = pickle.load(fh)
            except Exception:
                host_state = None
        # the pickle must not resurrect state the validating stores just
        # refused: a live template is a layout contract here too
        ok = host_state is not None and all(
            self._pickle_matches_template(self._tree(name),
                                          host_state.get(name))
            for name in self.PYTREE_FIELDS)
        if not self._all_ranks_agree(ok):
            return False
        for k, v in host_state.items():
            if k in self.PYTREE_FIELDS:
                self._apply(k, v)
            else:
                setattr(self, k, v)
        self.last_restore = {"format": "pickle", "step": None}
        self.save()
        return True

    @staticmethod
    def _pickle_matches_template(template: Any, stored: Any) -> bool:
        """No template (None) accepts anything; otherwise the stored tree
        must match the template leaf for leaf in shape and dtype."""
        if template is None or stored is None:
            return True
        return tree_matches_template(template, stored, devices=False)


def tree_matches_template(template: Any, stored: Any,
                          devices: bool = True) -> bool:
    """``stored`` has ``template``'s structure, and each tensor leaf its
    template's shape and dtype (and device kind, with ``devices``)."""
    if template is None or stored is None:
        return template is None or stored is not None
    t_leaves, t_def = flatten(template)
    s_leaves, s_def = flatten(stored)
    if t_def != s_def or len(t_leaves) != len(s_leaves):
        return False
    for t, s in zip(t_leaves, s_leaves):
        if isinstance(t, torch.Tensor) != isinstance(s, torch.Tensor):
            return False
        if not isinstance(t, torch.Tensor):
            continue
        if tuple(t.shape) != tuple(s.shape) or t.dtype != s.dtype:
            return False
        if devices and t.device.type != s.device.type:
            return False
    return True


def decide_restore_plan(views, commit_format: str):
    """The rule of ``TreeState._agreed_restore_plan`` over the ranks'
    views ``(own fast steps {step: marker mtime}, portable step, its
    mtime)``: ``(fast_step, use_fast, agreed_portable_step)``."""
    common = set(views[0][0])
    for v in views[1:]:
        common &= set(v[0])
    fast_step = max(common) if common else None
    port_views = {v[1] for v in views}
    port_step = views[0][1]
    agreed_port = (port_step if port_views == {port_step}
                   and port_step is not None else None)
    if fast_step is None:
        return None, False, agreed_port
    if agreed_port is None:
        return fast_step, True, None
    max_fast_t = max((v[0].get(fast_step) or 0) for v in views)
    max_port_t = max((v[2] for v in views if v[2] is not None), default=0)
    if max_fast_t == max_port_t:
        return fast_step, commit_format == "fast", agreed_port
    return fast_step, max_fast_t > max_port_t, agreed_port
