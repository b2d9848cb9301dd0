"""The ('dp', 'tp') mesh on ``torch.distributed``: the port of
``theatergen_tpu/parallel/mesh.py``.

JAX's mesh is one host program over SPMD device code, and XLA inserts the
collectives from the parameters' shardings.  Here every GPU has a process
of its own (a rank), and the port issues its collectives itself:

- :func:`make_mesh` returns a :class:`Mesh`: rank = dp_index · tp +
  tp_index, as JAX's ``reshape(dp, tp)`` lays the devices out, with a
  process group per tp row and per dp column, and a gloo group over the
  world for the host's messages (``parallel/worker.py``);
- :func:`init_distributed` is ``initialize_multihost``'s counterpart: it
  reads torchrun's environment (or takes an address, a rank and a world
  size) and does nothing in a single process;
- the backend follows the device, NCCL for CUDA and gloo for the CPU;
  only an explicit ``backend=`` picks another (two ranks sharing one card
  over gloo, which takes CUDA tensors), and a CUDA mesh without NCCL
  raises;
- every collective goes through ``parallel/collectives.py``, which
  counts calls and bytes per op on the mesh; :func:`collective_stats`
  returns JAX's ``{op: {"count", "bytes"}}`` from those counts, the
  counterpart of JAX's HLO parser;
- :data:`TP_RULES` are JAX's ``_TP_RULES`` over the port's diffusers names
  (``models/weights.py::from_flax`` maps one onto the other), in the
  port's ``[out, in]`` layout: ``("tp", None)`` shards the output rows
  (column-parallel), ``(None, "tp")`` the input columns (row-parallel).
  :func:`shard_module` swaps the matched linears of a UNet or ControlNet
  for ``models/layers.py``'s column- and row-parallel layers holding only
  their shard; :func:`sharding_coverage` reports what it shards.

Two rules go beyond JAX's divisibility guard, because the port's layers
compute per rank and GSPMD's do not: an attention module whose head count
does not divide by tp stays replicated whole (SDXL's 10-head 640-channel
level at tp = 4, although ``640 % 4 == 0``), and the layers that pair up
(q/k/v/ip with ``to_out.0``, GEGLU's ``proj`` with ``net.2``,
``linear_1`` with ``linear_2``) shard together or not at all.
"""

from __future__ import annotations

import copy
import datetime
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..models import layers

# how long a collective or a host message may wait for a peer before its
# group raises (a rank that died leaves the others waiting this long)
DEFAULT_TIMEOUT_S = 600
# how long a worker waits for rank 0's next command: rank 0 runs the host
# program (detection, decoding, a serial pass) between two commands; a
# rank 0 that dies is ended by the launcher (spawn, torchrun)
COMMAND_TIMEOUT_S = 24 * 3600

# JAX's four ops (collective_stats' keys there) and the host's messages
JAX_OPS = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute")
HOST_OPS = ("scatter", "gather")

def backend_for(device, backend: Optional[str] = None) -> str:
    """The process groups' backend for ``device``: ``backend`` where given,
    else NCCL for CUDA (raising where this torch has none) and gloo for
    the CPU."""
    if backend is not None:
        return backend
    dev = torch.device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL, which this torch "
                               "lacks; pass backend= to pick another")
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {dev}")


def init_distributed(device="cuda", *, backend: Optional[str] = None,
                     address: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start this process's rank: ``init_process_group`` at ``address``
    (``tcp://host:port``) with ``rank`` and ``world_size`` where given,
    else from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``).  Returns False, doing nothing, in a
    single process (no address and no ``WORLD_SIZE``) or where a group is
    already up.  On a CUDA device the rank takes ``cuda:LOCAL_RANK`` (or
    its rank modulo the cards) as its current device."""
    if dist.is_initialized():
        return False
    if address is None and "WORLD_SIZE" not in os.environ:
        return False
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass "
                               "device='cpu' for a CPU mesh")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend_for(dev, backend), init_method=address or "env://",
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def _rank_device(device="cuda") -> torch.device:
    """This rank's device: a CUDA device names the current card (set by
    :func:`init_distributed`)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A ('dp', 'tp') mesh over this process's world.  ``shape`` is JAX's
    ``{"dp": dp, "tp": tp}``; :meth:`group` gives the process group of an
    axis through this rank (None where the axis has size 1, or in a
    one-process mesh); ``counts`` holds the collectives issued through
    this module.  A mesh is neither copied (a ``deepcopy`` of a sharded
    module shares it) nor pickled."""

    def __init__(self, dp: int, tp: int, rank: int, device: torch.device,
                 backend: Optional[str], groups: Dict[str, Any]):
        self.dp, self.tp, self.rank = dp, tp, rank
        self.world = dp * tp
        self.device, self.backend = device, backend
        self._groups = groups
        self.counts = {op: {"count": 0, "bytes": 0}
                       for op in JAX_OPS + HOST_OPS}
        # this process's per-mesh state (parallel/worker.py, driver.py):
        # targets registered by name, tp-sharded bundles, built runners
        self.local = {"targets": {}, "bundles": {}, "runners": {}}

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp

    def index(self, axis: str) -> int:
        return self.dp_index if axis == "dp" else self.tp_index

    def group(self, axis: str):
        return self._groups.get(axis)

    def __deepcopy__(self, memo):
        return self

    def __reduce__(self):
        raise TypeError("a Mesh holds process groups and is not pickled")

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, tp={self.tp}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


def make_mesh(dp: int = -1, tp: int = 1, *, device="cuda",
              timeout_s: float = DEFAULT_TIMEOUT_S,
              command_timeout_s: float = COMMAND_TIMEOUT_S) -> Mesh:
    """The ('dp', 'tp') mesh over the world of ranks (``dp=-1``: all the
    ranks left by tp).  Every rank calls it, in the same order as its
    peers; its groups take the backend :func:`init_distributed` chose.
    Without a process group the world is this process alone, so only
    dp = tp = 1 is taken.  Device groups and the host group wait
    ``timeout_s`` for a peer, the command group (a worker's wait for rank
    0, ``parallel/worker.py``) ``command_timeout_s``."""
    device = _rank_device(device)
    if not dist.is_initialized():
        dp = 1 if dp == -1 else dp
        if dp * tp != 1:
            raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks; start "
                             f"them with init_distributed first")
        return Mesh(1, 1, 0, device, None, {})
    n, rank = dist.get_world_size(), dist.get_rank()
    if dp == -1:
        if n % tp:
            raise ValueError(f"{n} ranks do not divide by tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} != {n} ranks")
    backend = dist.get_backend()
    timeout = datetime.timedelta(seconds=timeout_s)
    groups = {}
    # every rank creates every group, in one order
    for i in range(dp):
        ranks = [i * tp + j for j in range(tp)]
        g = dist.new_group(ranks, timeout=timeout, backend=backend)
        if rank in ranks and tp > 1:
            groups["tp"] = g
    for j in range(tp):
        ranks = [i * tp + j for i in range(dp)]
        g = dist.new_group(ranks, timeout=timeout, backend=backend)
        if rank in ranks and dp > 1:
            groups["dp"] = g
    groups["host"] = dist.new_group(list(range(n)), timeout=timeout,
                                    backend="gloo")
    groups["command"] = dist.new_group(
        list(range(n)), backend="gloo",
        timeout=datetime.timedelta(seconds=command_timeout_s))
    return Mesh(dp, tp, rank, device, backend, groups)


# ------------------------------------------------------------------ counters

def reset_stats(mesh: Mesh) -> None:
    for c in mesh.counts.values():
        c["count"] = c["bytes"] = 0


def collective_stats(mesh: Mesh) -> dict:
    """``{op: {"count": n, "bytes": payload}}`` of the collectives this rank
    issued through the mesh since :func:`reset_stats`: JAX's four ops
    (``all-reduce``, ``all-gather``, ``reduce-scatter``,
    ``collective-permute``; payload = the result's bytes, as JAX counts
    an HLO line) and the host's messages (``scatter``, ``gather``:
    the bytes of the tensors they carry)."""
    return {op: dict(c) for op, c in mesh.counts.items()}


# ----------------------------------------------------------------- tp rules

# (regex over the port's parameter names, spec over [out, in]); first match
# wins.  JAX's P(None, "tp") over a kernel [in, out] is ("tp", None) here.
# As JAX's ".*/name" needs a scope above the layer, so does ".*\.name": the
# UNet's top-level time_embedding matches neither and stays replicated (a
# time_embedding inside a scope would shard)
TP_RULES = [
    (re.compile(r".*\.(to_q|to_k|to_v|to_k_ip|to_v_ip)\.weight$"),
     ("tp", None)),
    (re.compile(r".*\.(to_q|to_k|to_v|to_k_ip|to_v_ip)\.scale$"),
     ("tp",)),
    (re.compile(r".*\.(q_proj|k_proj|v_proj)\.weight$"), ("tp", None)),
    (re.compile(r".*\.to_out\.0\.weight$"), (None, "tp")),
    (re.compile(r".*\.out_proj\.weight$"), (None, "tp")),
    (re.compile(r".*\.ff\.net\.0\.proj\.weight$"), ("tp", None)),
    (re.compile(r".*\.ff\.net\.0\.proj\.scale$"), ("tp",)),
    (re.compile(r".*\.ff\.net\.2\.weight$"), (None, "tp")),
    (re.compile(r".*\.mlp\.fc1\.weight$"), ("tp", None)),
    (re.compile(r".*\.mlp\.fc2\.weight$"), (None, "tp")),
    (re.compile(r".*\.time_embedding\.linear_1\.weight$"), ("tp", None)),
    (re.compile(r".*\.time_embedding\.linear_1\.scale$"), ("tp",)),
    (re.compile(r".*\.time_embedding\.linear_2\.weight$"), (None, "tp")),
]


def param_spec(name: str) -> tuple:
    """The tp spec of a parameter, by its port name (``()``: replicated)."""
    for rx, spec in TP_RULES:
        if rx.match(name):
            return spec
    return ()


def _units(module) -> List[Tuple[str, str, Dict[str, str]]]:
    """The tp units of ``module``: ``(unit name, reason or "", {linear name:
    "column" | "geglu" | "row"})`` for every attention, FF and time
    embedding whose weights the rules match; the reason says why a unit
    cannot shard at ``tp`` (filled by :func:`plan`).  A GLIGEN fuser's
    attention (a self-attention over ``[x ‖ objs]``) and FF are units as
    any other, since JAX's rules match their ``attn/to_q`` … and
    ``ff/net_0``/``net_2`` paths; its ``linear`` matches no rule and stays
    replicated, as in the JAX package."""
    out = []
    for name, m in module.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, layers.CrossAttention):
            kinds = {f"{pre}{p}": "column" for p in
                     ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip")
                     if hasattr(m, p)}
            kinds[f"{pre}to_out.0"] = "row"
            out.append((name, m, kinds))
        elif isinstance(m, layers.FeedForward):
            out.append((name, m, {f"{pre}net.0.proj": "geglu",
                                  f"{pre}net.2": "row"}))
        elif isinstance(m, layers.TimestepEmbedding):
            out.append((name, m, {f"{pre}linear_1": "column",
                                  f"{pre}linear_2": "row"}))
    return [(n, m, k) for n, m, k in out
            if all(param_spec(f"{ln}.weight") for ln in k)]


def plan(module, tp: int) -> List[Tuple[str, Any, Dict[str, str], str]]:
    """:func:`_units` with each unit's reason not to shard at ``tp`` ("" where
    it shards): JAX's guard (a sharded dim that tp does not divide) and the
    port's head rule."""
    out = []
    for name, m, kinds in _units(module):
        reason = ""
        if isinstance(m, layers.CrossAttention) and m.heads % tp:
            reason = f"{m.heads} heads do not split over tp={tp}"
        for ln, kind in kinds.items():
            lin = module.get_submodule(ln)
            dim = lin.in_features if kind == "row" else lin.out_features
            if kind == "geglu":
                dim //= 2
            if not reason and dim % tp:
                reason = f"{ln}: width {dim} does not divide by tp={tp}"
        out.append((name, m, kinds, reason))
    return out


def sharding_coverage(mesh, module) -> dict:
    """What the tp rules shard of ``module``'s parameters and buffers at the
    mesh's tp (``mesh`` may be a tp size): JAX's ``{'total_params',
    'sharded_params', 'fraction', 'matched_fraction', 'fallback'}``, the
    fallback listing rule-matched tensors that stay replicated, and
    ``reasons`` (fallback name → why).  Counted by spec, as JAX counts:
    a column-parallel layer's bias shards with it but is not counted."""
    tp = mesh if isinstance(mesh, int) else mesh.tp
    why = {}
    for _, _, kinds, reason in plan(module, tp):
        if reason:
            why.update({ln: reason for ln in kinds})
    total = sharded = matched = 0
    fallback, reasons = [], {}
    for name, t in module.state_dict(keep_vars=True).items():
        n = t.numel()
        total += n
        if not param_spec(name):
            continue
        matched += n
        layer = name.rsplit(".", 1)[0]
        if layer in why:
            fallback.append(name)
            reasons[name] = why[layer]
        else:
            sharded += n
    return {"total_params": total, "sharded_params": sharded,
            "fraction": sharded / max(total, 1),
            "matched_fraction": matched / max(total, 1),
            "fallback": fallback, "reasons": reasons}


def shard_rows(kind: str, size: int, tp: int, index: int) -> torch.Tensor:
    """Indices of rank ``index``'s shard of a dim of ``size``: a contiguous
    block, or for GEGLU's ``[value ‖ gate]`` rows the value block and the
    gate block at the same offset past the half."""
    if kind == "geglu":
        half = size // 2
        block = torch.arange(index * half // tp, (index + 1) * half // tp)
        return torch.cat([block, block + half])
    return torch.arange(index * size // tp, (index + 1) * size // tp)


def shard_specs(module, tp: int) -> Dict[str, Tuple[str, int]]:
    """``{parameter name: (kind, dim)}`` of the parameters
    :func:`shard_module` cuts at ``tp``: a column-parallel weight and
    bias along dim 0 ("column" or "geglu"), a row-parallel weight along
    dim 1 ("row"; its bias stays whole)."""
    specs = {}
    for _, _, kinds, reason in plan(module, tp):
        if reason:
            continue
        for ln, kind in kinds.items():
            lin = module.get_submodule(ln)
            specs[f"{ln}.weight"] = (kind, 1 if kind == "row" else 0)
            if kind != "row" and lin.bias is not None:
                specs[f"{ln}.bias"] = (kind, 0)
    return specs


def shard_tensor(t: torch.Tensor, kind: str, dim: int, tp: int,
                 index: int) -> torch.Tensor:
    """Rank ``index``'s shard of an unsharded tensor (:func:`shard_rows`)."""
    idx = shard_rows(kind, t.shape[dim], tp, index).to(t.device)
    return t.index_select(dim, idx).contiguous()


def unshard(parts: List[torch.Tensor], kind: str,
            dim: int) -> torch.Tensor:
    """The unsharded tensor of every rank's shard, in tp order (GEGLU's
    value halves first, then the gate halves)."""
    if kind == "geglu":
        halves = [p.chunk(2, dim) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves],
                         dim)
    return torch.cat(parts, dim)


def shard_module(module, mesh: Mesh, *, inplace: bool = False):
    """``module`` (a UNet or ControlNet) with every unit of :func:`plan`
    that shards at the mesh's tp swapped for ``models/layers.py``'s
    parallel layers holding this rank's shard: q/k/v, the IP branch's
    ``to_k_ip``/``to_v_ip``, GEGLU's ``proj`` and ``linear_1``
    column-parallel, ``to_out.0``, ``net.2`` and ``linear_2``
    row-parallel; an attention then holds ``heads / tp`` heads.  A copy
    unless ``inplace``; tp = 1 returns ``module`` itself.  Parameter and
    buffer names stay the unsharded module's."""
    if mesh.tp == 1:
        return module
    if not inplace:
        module = copy.deepcopy(module)
    for name, unit, kinds, reason in plan(module, mesh.tp):
        if reason:
            continue
        for ln, kind in kinds.items():
            parent, _, leaf = ln.rpartition(".")
            owner = module.get_submodule(parent) if parent else module
            old = module.get_submodule(ln)
            dim = old.in_features if kind == "row" else old.out_features
            new = layers.parallel_linear(
                old, kind, mesh, shard_rows(kind, dim, mesh.tp,
                                            mesh.tp_index))
            if isinstance(owner, torch.nn.ModuleList):
                owner[int(leaf)] = new
            else:
                setattr(owner, leaf, new)
        if isinstance(unit, layers.CrossAttention):
            unit.heads //= mesh.tp
        unit.tp_mesh = mesh
    return module
