"""The ranks of a mesh under one controller.

JAX's ``--mesh`` is one host program over SPMD device code.  The port
keeps that shape over ``torch.distributed``: rank 0 runs everything the
JAX host runs (the ``Theater``, the CLI loop, the server, the character
DB and the output tree), and every other rank runs :func:`serve`, a loop
that waits for rank 0's commands:

- ``("run", spec, payload)``: run this rank's dp shard of a character or
  final batch (``parallel/driver.py``: ``spec`` names the runner and its
  options, ``payload`` holds the rows), or call a target that both sides
  registered (a sharded train step, ``training/diffusion.py``), and send
  the result back;
- ``("stop",)``: leave the loop, exit code 0;
- ``("abort",)``: rank 0 failed; leave the loop, exit code 1.

Rank 0 sends a command with :func:`dispatch`, which also runs rank 0's own
shard and gathers every rank's answer: a rank that raised answers with its
traceback, and :func:`dispatch` raises :class:`RankError` with it once
every rank has answered, so the mesh stays in step.  :func:`run_rank` runs
rank 0's program: it sends ``stop`` at its end and ``abort`` where it
raises, so a failure on any rank makes every rank exit non-zero.
Messages travel over the mesh's gloo host group (tensors on the CPU); the
collectives inside a shard's run go over the device groups.
"""

from __future__ import annotations

import dataclasses
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch

from . import collectives


class RankError(RuntimeError):
    """A command failed on a rank of the mesh; the message carries each
    failed rank's traceback.  The CLI does not quarantine it: the mesh
    ends."""


def _to(x, device):
    """``x`` (a tensor, or a dict, list, tuple or dataclass of them) with
    every tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        if hasattr(x, "to"):
            return x.to(device)
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), device)
            for f in dataclasses.fields(x) if f.init})
    return x


def register(mesh, name: str, target: Any) -> None:
    """Make ``target`` callable by name through :func:`dispatch`'s
    ``("call", name, method)`` specs; rank 0 and every worker register
    their own object under the same name."""
    mesh.local["targets"][name] = target


def _execute(mesh, bundle, spec: dict, payload):
    from . import driver

    if spec["kind"] == "call":
        target = mesh.local["targets"][spec["name"]]
        return getattr(target, spec["method"])(*payload)
    return driver.run_local(mesh, bundle, spec, payload)


def dispatch(mesh, spec: dict, payloads: List[Any], bundle=None) -> list:
    """Run ``spec`` on every rank, rank r on ``payloads[r]``; returns every
    rank's result (rank 0's on its device, the others' on the CPU).  A
    one-rank mesh runs rank 0's alone.  Raises :class:`RankError` where a
    rank raised, after every rank has answered."""
    if mesh.world == 1:
        return [_execute(mesh, bundle, spec, payloads[0])]
    collectives.scatter_objects(
        mesh, [None] + [("run", spec, _to(p, "cpu")) for p in payloads[1:]],
        group="command")
    try:
        own = (True, _execute(mesh, bundle, spec, payloads[0]))
    except Exception:
        own = (False, traceback.format_exc())
    answers = collectives.gather_objects(mesh, own)
    answers[0] = own
    failed = [f"rank {r}:\n{a[1]}" for r, a in enumerate(answers)
              if not a[0]]
    if failed:
        raise RankError("a mesh command failed\n" + "\n".join(failed))
    return [a[1] for a in answers]


def serve(mesh, bundle=None,
          targets: Optional[Dict[str, Any]] = None) -> int:
    """The loop of a rank ≥ 1: answer rank 0's commands until ``stop``
    (returns 0) or ``abort`` (returns 1).  ``bundle`` is this rank's copy
    of rank 0's bundle (the runners' tp shards come from it); ``targets``
    are registered by name.  A command that raises answers with its
    traceback and the loop goes on."""
    if mesh.rank == 0:
        raise ValueError("serve runs on the ranks other than 0")
    for name, target in (targets or {}).items():
        register(mesh, name, target)
    while True:
        cmd = collectives.scatter_objects(mesh, group="command")
        if cmd[0] == "stop":
            return 0
        if cmd[0] == "abort":
            return 1
        _, spec, payload = cmd
        try:
            result = _execute(mesh, bundle, spec,
                              _to(payload, mesh.device))
            answer = (True, _to(result, "cpu"))
        except Exception:
            answer = (False, traceback.format_exc())
        collectives.gather_objects(mesh, answer)


def _send(mesh, code: str) -> None:
    if mesh.world > 1:
        collectives.scatter_objects(mesh, [None] + [(code,)] * (mesh.world - 1),
                                 group="command")


def run_rank(mesh, main: Callable[[], Any], bundle=None,
             targets: Optional[Dict[str, Any]] = None) -> int:
    """One rank's program: rank 0 runs ``main``, then sends ``stop`` to the
    other ranks, or ``abort`` where ``main`` raises (the exception goes
    on), and returns 0; the others :func:`serve` and return its exit
    code."""
    if mesh.rank != 0:
        return serve(mesh, bundle, targets)
    try:
        main()
    except BaseException:
        try:
            _send(mesh, "abort")
        except Exception:       # a peer already gone: the launcher ends it
            traceback.print_exc()
        raise
    _send(mesh, "stop")
    return 0


def free_address(host: str = "127.0.0.1") -> str:
    """``tcp://host:port`` at a port free now, for a local world's rendezvous
    (torch.distributed is told its address; nothing tells it of a
    cluster)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return f"tcp://{host}:{s.getsockname()[1]}"


def spawn(fn: Callable, world: int, args: tuple = (), *,
          timeout_s: Optional[float] = None) -> None:
    """Run ``fn(rank, world, address, *args)`` in ``world`` fresh processes
    (``torch.multiprocessing``, ``spawn``: no fork after CUDA starts) and
    wait for them.  A rank that raises or exits non-zero ends the others
    and raises here (``torch.multiprocessing``'s ``ProcessRaisedException``
    or ``ProcessExitedException``); past ``timeout_s`` every rank is
    killed and ``TimeoutError`` raised, so a deadlock cannot outlive it.
    ``fn`` is pickled by its import path."""
    import torch.multiprocessing as tmp

    address = free_address()
    ctx = tmp.start_processes(fn, args=(world, address) + tuple(args),
                              nprocs=world, join=False,
                              start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if deadline is not None and time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(10)
            raise TimeoutError(f"{world} ranks did not finish within "
                               f"{timeout_s} s")
