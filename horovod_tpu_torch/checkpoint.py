"""Checkpointing: the port of ``horovod_tpu/checkpoint.py``'s
``CheckpointManager``, ``save_checkpoint`` and ``restore_checkpoint``.

The JAX module wraps orbax, where every host writes its own shards.  The
port's store is ``torch.save`` of each tree (a state dict, an optimizer
state dict, or any nesting of dicts, lists and tensors) under
``<dir>/<step>/<item>.pt``, written by rank 0 alone (the other ranks of an
initialized process group wait for it at a barrier) and read back with
``weights_only=True``:

    ckpt = CheckpointManager(path, max_to_keep=3)
    ckpt.save(step, params=model.state_dict(), opt_state=opt.state_dict(),
              meta={"epoch": 2})
    state = ckpt.restore(step=None, params=model.state_dict())

As in the JAX module, the trees given to ``restore`` are templates: a
restored tensor takes its template tensor's device and dtype, and only the
items both requested and saved come back, with ``meta`` (any picklable
value) whenever it was saved.  A step is written into a temporary
directory and renamed into place, so a crash mid-save leaves no partial
step behind.  ``elastic.TreeState(commit_format="portable")`` commits
through this module (``latest_step`` and ``step_mtime`` order its commits
against the fast store's).
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

_META = "meta.pkl"


def _is_writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _like(value: Any, template: Any) -> Any:
    """``value`` (a loaded tree) placed like ``template``: each tensor
    takes its template tensor's device and dtype."""
    if isinstance(template, torch.Tensor) and isinstance(value,
                                                         torch.Tensor):
        return value.to(device=template.device, dtype=template.dtype)
    if isinstance(template, dict) and isinstance(value, dict):
        return {k: _like(v, template[k]) if k in template else v
                for k, v in value.items()}
    if isinstance(template, (list, tuple)) and \
            isinstance(value, (list, tuple)) and len(template) == len(value):
        return type(value)(_like(v, t) for v, t in zip(value, template))
    return value


class CheckpointManager:
    """Numbered checkpoints under one directory, at most ``max_to_keep``
    of them (the oldest are deleted after a save)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    # ------------------------------------------------------------------ save
    def save(self, step: int, params: Any = None, opt_state: Any = None,
             meta: Optional[Dict[str, Any]] = None, force: bool = False,
             **extra_trees: Any) -> bool:
        """Write one checkpoint; returns False when ``step`` exists and
        ``force`` is not set (the step is left as it was)."""
        final = self._step_dir(step)
        if os.path.exists(final) and not force:
            return False
        if _is_writer():
            tmp = os.path.join(self.directory, f".tmp-{int(step)}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for name, tree in dict(params=params, opt_state=opt_state,
                                   **extra_trees).items():
                if tree is not None:
                    torch.save(tree, os.path.join(tmp, f"{name}.pt"))
            if meta:
                with open(os.path.join(tmp, _META), "wb") as f:
                    pickle.dump(meta, f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            steps = self.all_steps()
            for old in steps[:max(0, len(steps) - self.max_to_keep)]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        _barrier()
        return True

    # --------------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None, params: Any = None,
                opt_state: Any = None, **extra_trees: Any) -> Dict[str, Any]:
        """Restore ``step`` (default: the latest).  The trees given are
        templates (see the module docstring); raises FileNotFoundError
        when there is no such step."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint under {self.directory}")
        d = self._step_dir(step)
        if not os.path.isdir(d):
            raise FileNotFoundError(f"no checkpoint step {step} under "
                                    f"{self.directory}")
        out: Dict[str, Any] = {}
        for name, tmpl in dict(params=params, opt_state=opt_state,
                               **extra_trees).items():
            path = os.path.join(d, f"{name}.pt")
            if tmpl is not None and os.path.exists(path):
                out[name] = _like(torch.load(path, map_location="cpu",
                                             weights_only=True), tmpl)
        if os.path.exists(os.path.join(d, _META)):
            with open(os.path.join(d, _META), "rb") as f:
                out["meta"] = pickle.load(f)
        return out

    def load_item(self, step: int, name: str = "params") -> Any:
        """One saved tree as written, on the CPU, without a template."""
        return torch.load(os.path.join(self._step_dir(step), f"{name}.pt"),
                          map_location="cpu", weights_only=True, mmap=True)

    # ------------------------------------------------------------- inventory
    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_mtime(self, step: int) -> Optional[float]:
        """When ``step`` was written."""
        try:
            return os.path.getmtime(self._step_dir(step))
        except OSError:
            return None


def save_checkpoint(directory: str, step: int, params: Any = None,
                    opt_state: Any = None,
                    meta: Optional[Dict[str, Any]] = None) -> None:
    """One-shot save; every rank may call it, rank 0 writes."""
    mgr = CheckpointManager(directory, max_to_keep=10_000)
    mgr.save(step, params=params, opt_state=opt_state, meta=meta,
             force=True)


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       params: Any = None, opt_state: Any = None
                       ) -> Dict[str, Any]:
    return CheckpointManager(directory, max_to_keep=10_000).restore(
        step, params=params, opt_state=opt_state)
