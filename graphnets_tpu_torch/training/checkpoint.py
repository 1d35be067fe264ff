"""Checkpoint and resume (counterpart of
``graphnets_tpu/training/checkpoint.py``, which saves through Orbax).

A checkpoint is one directory per step holding one ``torch.save`` file of
the state's ``state_dict``s: the model's parameters, the optimizer's state,
the step count and every generator's state (a ``TrainState``: the JAX
``TrainState``'s params, opt_state, step and rng).  Zero-size tensors
(zero-width feature sets) round-trip as they are.

Restoring writes into the live objects in place: parameters and optimizer
state tensors are copied into, not replaced, so a step captured as a CUDA
graph (``training/train.CapturedStep``), which keeps the addresses it
captured, goes on from the restored state without a recapture.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, List, Optional

import torch
from torch import nn

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint"]

_FILE = "state.pt"


def _to_host(x: Any) -> Any:
    """``x`` with every tensor copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _encode(state: Any) -> Any:
    """What is saved of ``state``: the ``state_dict`` of a module or an
    optimizer, a generator's state, tensors on the host; dataclasses,
    dicts, lists and tuples walked; other leaves as they are."""
    if isinstance(state, (nn.Module, torch.optim.Optimizer)):
        return _to_host(state.state_dict())
    if isinstance(state, torch.Generator):
        return state.get_state()
    if isinstance(state, torch.Tensor):
        return _to_host(state)
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return {f.name: _encode(getattr(state, f.name))
                for f in dataclasses.fields(state)}
    if isinstance(state, dict):
        return {k: _encode(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [_encode(v) for v in state]
    return state


def _copy_into(live: torch.Tensor, saved: torch.Tensor, what: str,
               write: bool) -> None:
    if tuple(live.shape) != tuple(saved.shape):
        raise ValueError(f"checkpoint: {what} has shape {tuple(saved.shape)}"
                         f", the live tensor {tuple(live.shape)}")
    if write:
        with torch.no_grad():
            live.copy_(saved)


def _restore_module(module: nn.Module, saved: dict, write: bool) -> None:
    live = module.state_dict()
    if set(live) != set(saved):
        raise ValueError(
            f"checkpoint: the saved module has entries "
            f"{sorted(set(saved) ^ set(live))[:8]} the live one lacks or "
            "the other way round")
    for name, t in live.items():
        _copy_into(t, saved[name], name, write)


def _restore_optimizer(opt: torch.optim.Optimizer, saved: dict,
                       write: bool) -> None:
    params = [p for g in opt.param_groups for p in g["params"]]
    if len(saved["param_groups"]) != len(opt.param_groups):
        raise ValueError("checkpoint: the optimizer's parameter groups "
                         "differ from the saved ones")
    state = saved["state"]
    live_idx = {i for i, p in enumerate(params) if opt.state.get(p)}
    if not live_idx:
        # A fresh optimizer has no state to copy into: it takes the saved
        # one (nothing can have captured tensors it does not have yet),
        # except a scheduled learning rate, which keeps its tensor.
        if write:
            kept = [{k: v for k, v in g.items()
                     if isinstance(v, torch.Tensor)}
                    for g in opt.param_groups]
            opt.load_state_dict(saved)
            for group, tensors in zip(opt.param_groups, kept):
                for k, v in tensors.items():
                    with torch.no_grad():
                        v.copy_(torch.as_tensor(group[k]))
                    group[k] = v
        return
    if live_idx != set(state) or any(
            set(opt.state[params[i]]) != set(st) for i, st in state.items()):
        # load_state_dict would replace tensors a captured step may hold.
        raise ValueError(
            "checkpoint: the live optimizer holds state that does not match "
            "the saved one; restore into a fresh optimizer instead")
    for i, st in state.items():
        live = opt.state[params[i]]
        for k, v in st.items():
            if isinstance(live[k], torch.Tensor):
                _copy_into(live[k], torch.as_tensor(v), f"optimizer {k}",
                           write)
            elif write:
                live[k] = v
    if write:
        _restore_groups(opt, saved["param_groups"])


def _restore_groups(opt: torch.optim.Optimizer, groups) -> None:
    """Write the hyperparameters of ``groups`` into the optimizer's groups:
    a tensor (a scheduled learning rate, which a captured step reads) in
    place, any other value by assignment."""
    for group, sg in zip(opt.param_groups, groups):
        for k, v in sg.items():
            if k == "params":
                continue
            if isinstance(group.get(k), torch.Tensor):
                with torch.no_grad():
                    group[k].copy_(torch.as_tensor(v))
            else:
                group[k] = v


def _restore(live: Any, saved: Any, write: bool = True) -> Any:
    """``live`` with ``saved`` written into it (modules, optimizers,
    generators and tensors in place); returns the restored value.  With
    ``write`` False it only checks that ``saved`` fits ``live``, so a
    checkpoint that does not fit raises before anything is written."""
    if isinstance(live, nn.Module):
        _restore_module(live, saved, write)
        return live
    if isinstance(live, torch.optim.Optimizer):
        _restore_optimizer(live, saved, write)
        return live
    if isinstance(live, torch.Generator):
        if write:
            live.set_state(saved)
        return live
    if isinstance(live, torch.Tensor):
        _copy_into(live, saved, "tensor", write)
        return live
    if dataclasses.is_dataclass(live) and not isinstance(live, type):
        return dataclasses.replace(live, **{
            f.name: _restore(getattr(live, f.name), saved[f.name], write)
            for f in dataclasses.fields(live) if f.init})
    if isinstance(live, dict):
        return {k: _restore(v, saved[k], write) for k, v in live.items()}
    if isinstance(live, (list, tuple)):
        if len(live) != len(saved):
            raise ValueError(f"checkpoint: {len(saved)} saved entries for "
                             f"{len(live)} live ones")
        return type(live)(_restore(a, b, write) for a, b in zip(live, saved))
    return saved


class CheckpointManager:
    """Checkpoints of a training state in ``directory``, one subdirectory
    per step, the newest ``keep`` kept.

    ``save(step, state)`` writes a checkpoint when ``step`` is newer than
    the latest one and either no checkpoint exists yet or ``step`` is a
    multiple of ``save_interval_steps`` (Orbax's default policy), and says
    whether it did.  ``restore(state, step=None)`` writes the latest (or
    the given) checkpoint into the live ``state`` in place and returns the
    restored state.  Saves are written before ``save`` returns, through a
    temporary directory renamed into place, so ``wait`` and ``close``
    have nothing left to do.
    """

    def __init__(self, directory: str, keep: int = 3,
                 save_interval_steps: int = 1):
        if keep < 1 or save_interval_steps < 1:
            raise ValueError("keep and save_interval_steps must be >= 1")
        self._dir = os.path.abspath(directory)
        self.keep, self.save_interval_steps = keep, save_interval_steps
        os.makedirs(self._dir, exist_ok=True)

    def all_steps(self) -> List[int]:
        """The steps with a checkpoint, ascending."""
        return sorted(int(name) for name in os.listdir(self._dir)
                      if name.isdigit() and os.path.isfile(
                          os.path.join(self._dir, name, _FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, wait: bool = False) -> bool:
        latest = self.latest_step()
        if latest is not None and (step <= latest
                                   or step % self.save_interval_steps):
            return False
        tmp = os.path.join(self._dir, f"{step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(_encode(state), os.path.join(tmp, _FILE))
        os.replace(tmp, os.path.join(self._dir, str(step)))
        for old in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self._dir, str(old)))
        return True

    def restore(self, abstract_state: Any, step: Optional[int] = None
                ) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        saved = torch.load(os.path.join(self._dir, str(step), _FILE),
                           map_location="cpu", weights_only=True)
        _restore(abstract_state, saved, write=False)
        return _restore(abstract_state, saved)

    def wait(self) -> None:
        """Saves finish before ``save`` returns: nothing to wait for."""

    def close(self) -> None:
        """The manager holds no open file: nothing to close."""


def save_checkpoint(directory: str, step: int, state: Any) -> None:
    CheckpointManager(directory).save(step, state, wait=True)


def restore_checkpoint(directory: str, abstract_state: Any,
                       step: Optional[int] = None) -> Any:
    return CheckpointManager(directory).restore(abstract_state, step)
