"""Training-state checkpoints: the port of
``theatergen_tpu/training/checkpoint.py``, without orbax.

A checkpoint is a directory of two files: ``tensors.safetensors`` (every
tensor of the tree, by its path, written and read by the port's own
``models/weights.py::save_safetensors``/``load_safetensors``) and
``tree.json`` (the tree's structure and its scalars: counts, the step).
Any tree of dicts, :class:`TrainState` and :class:`AdamWState` with
tensor and scalar leaves round-trips bit for bit, so a caller saves ``{"state": state, "ema": ema}`` as orbax saves a
pytree.  :func:`latest_step_dir` keeps the ``{root}/step_{N}``
convention.

A tp-sharded state (``diffusion.ShardedTrainStep``) is gathered to rank 0
and written as the same two files the unsharded state writes
(:func:`save_sharded`); the sharded step's ``load`` reads such a file, or
an unsharded run's, on every rank and reshards it.  (JAX's orbax writes
across mesh shapes the same way, ``checkpoint.py:6-7``.)

:func:`from_flax_train_state` carries a JAX ``TrainState`` (numpy leaves,
the optax state as ``make_optimizer`` builds it) over into the port: the
parameters and both moments through ``from_flax("unet")``'s name map and
transposes, the Adam and schedule counts into the one count of
:class:`AdamWState`, so a JAX run stopped at step k goes on in the port.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..models.weights import from_flax, load_safetensors, save_safetensors
from .diffusion import AdamWState, TrainState

FORMAT = "theatergen_tpu_torch.checkpoint/1"
TENSORS, TREE = "tensors.safetensors", "tree.json"
_DATACLASSES = {c.__name__: c for c in (TrainState, AdamWState)}


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to load onto "
                           "the CPU")
    return device


def _encode(node, path: str, tensors: dict):
    if isinstance(node, torch.Tensor):
        tensors[path] = node
        return {"tensor": path}
    if dataclasses.is_dataclass(node) and type(node).__name__ in _DATACLASSES:
        return {"dataclass": type(node).__name__, "fields": {
            f.name: _encode(getattr(node, f.name), f"{path}/{f.name}",
                            tensors) for f in dataclasses.fields(node)}}
    if isinstance(node, Mapping):
        for k in node:
            if not isinstance(k, str) or "/" in k:
                raise TypeError(f"checkpoint keys must be strings without "
                                f"'/': {k!r} at {path or '/'}")
        return {"dict": {k: _encode(v, f"{path}/{k}", tensors)
                         for k, v in node.items()}}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    raise TypeError(f"cannot checkpoint a {type(node).__name__} at "
                    f"{path or '/'}")


def _child(target, key):
    if target is None:
        return None
    if dataclasses.is_dataclass(target):
        return getattr(target, key)
    return target[key]


def _decode(enc, tensors: dict, target, device):
    if "tensor" in enc:
        t = tensors[enc["tensor"]]
        if isinstance(target, torch.Tensor):
            return t.to(device=target.device, dtype=target.dtype, copy=True)
        return t.to(device=device, copy=True)
    if "dataclass" in enc:
        cls = _DATACLASSES[enc["dataclass"]]
        return cls(**{k: _decode(v, tensors, _child(target, k), device)
                      for k, v in enc["fields"].items()})
    if "dict" in enc:
        return {k: _decode(v, tensors, _child(target, k), device)
                for k, v in enc["dict"].items()}
    return enc["value"]


def save_checkpoint(path: str, state: Any, *, force: bool = True) -> None:
    """Save a tree (e.g. a ``TrainState``, or ``{"state": ..., "ema":
    ...}``) into the directory ``path``, replacing it where ``force``.
    The files are written beside it and moved into place, so an
    interrupted save leaves any earlier checkpoint there whole."""
    path = os.path.abspath(path)
    if os.path.exists(path) and not force:
        raise FileExistsError(path)
    tensors: dict = {}
    tree = _encode(state, "", tensors)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    save_safetensors(os.path.join(tmp, TENSORS), tensors)
    with open(os.path.join(tmp, TREE), "w") as f:
        json.dump({"format": FORMAT, "tree": tree}, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def load_checkpoint(path: str, target: Optional[Any] = None, *,
                    device="cuda") -> Any:
    """Restore the tree saved at ``path``.  Each tensor goes to the device
    and dtype of its counterpart in ``target`` (a tree of the same
    structure) where one is given, else to ``device`` (the card unless
    ``device='cpu'``); every tensor is a copy that owns its memory."""
    path = os.path.abspath(path)
    with open(os.path.join(path, TREE)) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: not a checkpoint of this format "
                         f"({meta.get('format')!r})")
    device = _device(device) if target is None else None
    tensors = load_safetensors(os.path.join(path, TENSORS))
    return _decode(meta["tree"], tensors, target, device)


def save_sharded(path: str, step, state: TrainState, ema=None, *,
                 force: bool = True) -> None:
    """Gather a sharded step's state (and the EMA, where given) over tp on
    rank 0 and write it there as :func:`save_checkpoint` writes the
    unsharded tree: ``state``, or ``{"state": state, "ema": ema}``.  Rank 0
    calls it; the other ranks answer in ``parallel.worker.serve``."""
    full = step.full(state)
    tree = full if ema is None else {"state": full, "ema": step.full(ema)}
    save_checkpoint(path, tree, force=force)


def latest_step_dir(root: str) -> Optional[str]:
    """Convention: ``{root}/step_{N}`` directories; returns the newest."""
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_"):
            try:
                steps.append((int(name.split("_", 1)[1]), name))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(root, max(steps)[1])


def _adam_and_schedule(opt_state):
    """The ``ScaleByAdamState`` and the ``ScaleByScheduleState`` counts of
    an optax state tree (named tuples, read by their fields)."""
    adam, counts, stack = None, [], [opt_state]
    while stack:
        node = stack.pop()
        fields = getattr(node, "_fields", None)
        if fields is not None and {"count", "mu", "nu"} <= set(fields):
            if adam is not None:
                raise ValueError("two Adam states in the optimizer state")
            adam = node
        elif fields == ("count",):
            counts.append(int(np.asarray(node.count)))
        elif isinstance(node, (tuple, list)):
            stack.extend(node)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer "
                         "state")
    return adam, counts


def from_flax_train_state(params: Mapping, opt_state, step, *,
                          device="cuda") -> TrainState:
    """The port's :class:`TrainState` of a JAX one: ``params`` and the
    Adam moments of ``opt_state`` (a flax UNet tree each) mapped by
    ``from_flax("unet")``, fp32, on ``device`` (the card unless
    ``device='cpu'``); the Adam count, which must equal the schedule's,
    and ``step``."""
    device = _device(device)
    adam, counts = _adam_and_schedule(opt_state)
    count = int(np.asarray(adam.count))
    if any(c != count for c in counts):
        raise ValueError(f"the schedule's counts {counts} differ from the "
                         f"Adam count {count}")

    def port(tree):
        return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
                for k, v in from_flax("unet", tree).items()}

    return TrainState(port(params), AdamWState(count, port(adam.mu),
                                               port(adam.nu)),
                      int(np.asarray(step)))
