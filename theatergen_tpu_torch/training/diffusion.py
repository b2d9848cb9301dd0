"""Diffusion training on one device: the port of
``theatergen_tpu/training/diffusion.py``.

The reference is tuning-free at run time, but its conditioning stack (the
IP-Adapter's ``to_k_ip``/``to_v_ip`` and ``ImageProjModel``) is a trained
artifact.  This module trains such adapters, or the whole UNet, with the
JAX package's recipe: epsilon-prediction MSE over the DDPM forward process
(:func:`diffusion_loss`), global-norm clipping, AdamW under a warmup-cosine
schedule (:func:`make_optimizer`, optax's chain step for step) and an
exponential moving average of the parameters (:func:`ema_update`).

PyTorch's idiom replaces the JAX one where the two differ:

- the step takes the port's ``UNet2DCondition`` itself, not an apply
  function; a ``torch.Generator`` draws ``t`` and the noise, or both are
  injected (``t=``, ``noise=``), which is how the tests hand the two
  packages the same draws;
- the state's tensors are updated in place (the fp32 master parameters,
  the moments and the EMA: 13.8 GB at SD1.5's width, which a functional
  update would double), and the step returns the same tensors in a
  :class:`TrainState` whose ``step`` is one higher;
- the JAX UNet keeps fp32 parameters and computes in bf16 (flax's
  ``param_dtype`` and ``dtype``); the port's kernels take bf16 only.  So
  the state holds fp32 masters and the module is the working copy in its
  own dtype: each step writes the masters into the module (a cast), runs
  the forward and backward there, and casts the gradients up, which is
  what the VJP of flax's cast does.  A master is never the module's own
  tensor, even where both are fp32 (the CPU tests), so one step object
  can step several states (a run and its resumed copy) without one
  overwriting the other;
- the trainable filter (``trainable_filter(name)`` on the port's dotted
  parameter names) sets ``requires_grad``.  A frozen parameter gets no
  gradient, no optimizer state and no update: the JAX step's zeroed
  gradient and re-masked update (``diffusion.py:88-94``), which keep
  decoupled weight decay off frozen parameters, hold by construction.

Over a ('dp', 'tp') mesh, :func:`shard_train_step` (the counterpart of
JAX's ``shard_train_step``, ``diffusion.py:109-113``) returns a
:class:`ShardedTrainStep`: the UNet holds its tp shard
(``parallel/mesh.shard_module``, so do the masters, the moments and the
EMA), each dp group takes its rows of the batch, the gradients are
averaged over dp, the global-norm clip sums the tp-sharded parameters'
squares over tp once (the replicated ones count once), and the loss
returned is the whole batch's mean.  Rank 0 drives it; the other ranks
answer through ``parallel/worker.py``.

The kernels' gradients are their autograd Functions (``ops/recompute.py``):
the forward launches the kernel, the backward recomputes the plain
version, as the JAX ``custom_vjp``s do.  A W8A8 UNet has no gradient
(``quant_matmul``, row 8, raises under autograd, as the JAX package's
int8 leaves refuse ``jax.grad``), so :func:`make_train_step` refuses it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..config import SchedulerConfig
from ..ops import scheduler as sched_ops
from ..parallel import collectives
from ..parallel import mesh as mesh_lib
from ..parallel import worker

# elements of one group of the optimizer's foreach arithmetic: its
# temporaries stay within 2 × 4 bytes × this
_GROUP_ELEMENTS = 1 << 26
# the JAX optimizer's constants: the schedule's length and its end as a
# share of the peak rate, the clipping norm, and optax's Adam defaults
DECAY_STEPS, END_SHARE, MAX_NORM = 100_000, 0.1, 1.0
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class AdamWState:
    """optax's ``ScaleByAdamState`` and ``ScaleByScheduleState``: one count
    (the two advance together), and the moments of the parameters the
    optimizer updates, by name (fp32)."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]   # fp32 masters, by the port's names
    opt_state: AdamWState
    step: int


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.chain(clip_by_global_norm(MAX_NORM), adamw(schedule,
    weight_decay=weight_decay))`` with ``schedule =
    warmup_cosine_decay_schedule(0, lr, warmup, DECAY_STEPS, END_SHARE ·
    lr)``, step for step: the schedule is read at the count before it
    advances (with a warmup the first update has rate 0); the gradients
    are scaled by ``MAX_NORM / norm`` only where their global norm is at
    least ``MAX_NORM``; the update is ``-rate · (m̂ / (sqrt(v̂) + EPS) + wd
    · p)``."""

    lr: float = 1e-4
    weight_decay: float = 1e-2
    warmup: int = 100

    def learning_rate(self, count: int) -> np.float32:
        """optax's ``warmup_cosine_decay_schedule`` at ``count``, in fp32
        as there: linear from 0 over ``warmup`` counts, then a cosine over
        ``DECAY_STEPS - warmup`` to ``END_SHARE · lr``."""
        f32 = np.float32
        if count < self.warmup:
            frac = f32(1) - f32(max(count, 0)) / f32(self.warmup)
            return f32(0.0 - self.lr) * frac + f32(self.lr)
        span = DECAY_STEPS - self.warmup
        # optax's end_value / peak_value, rounded as there
        alpha = 0.0 if self.lr == 0.0 else self.lr * END_SHARE / self.lr
        c = np.minimum(f32(count - self.warmup), f32(span))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(span)))
        return f32(self.lr) * (f32(1 - alpha) * cosine + f32(alpha))

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        """Zero moments for ``params`` (the ones to update)."""
        return AdamWState(
            0, {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()},
            {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.items()})

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor],
               state: AdamWState, norm: Optional[torch.Tensor] = None
               ) -> float:
        """One step over the parameters named in ``grads``, in place on
        ``params`` and ``state`` (whose count advances); the gradients are
        consumed (clipped in place).  ``norm`` is the gradients' global
        norm where the caller took it (a tp-sharded step: over every
        rank's shards).  Returns the rate it used.  No host
        synchronisation: the clipping decision stays on the device."""
        names = list(grads)
        g = [grads[n] for n in names]
        if norm is None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(g)))
        clip = ~(norm < MAX_NORM)           # optax's trigger, NaN included
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        # optax: (g / norm) * MAX_NORM where clipping, g untouched elsewhere
        torch._foreach_div_(g, torch.where(clip, norm, one))
        torch._foreach_mul_(g, torch.where(clip, one * MAX_NORM, one))
        rate = self.learning_rate(state.count)
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(B1) ** f32(count))
        bc2 = float(f32(1) - f32(B2) ** f32(count))
        for group in _groups(names, g):
            gs = [g[i] for i in group]
            ps = [params[names[i]] for i in group]
            mu = [state.mu[names[i]] for i in group]
            nu = [state.nu[names[i]] for i in group]
            torch._foreach_mul_(mu, B1)
            torch._foreach_add_(mu, gs, alpha=1 - B1)
            torch._foreach_mul_(nu, B2)
            torch._foreach_addcmul_(nu, gs, gs, value=1 - B2)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, EPS)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, denom)
            del denom
            torch._foreach_add_(upd, ps, alpha=self.weight_decay)
            torch._foreach_mul_(upd, -float(rate))
            torch._foreach_add_(ps, upd)
        state.count = count
        return float(rate)


def _groups(names: List[str], tensors: List[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` in runs of at most ``_GROUP_ELEMENTS``
    elements (a larger tensor alone)."""
    out, cur, size = [], [], 0
    for i, t in enumerate(tensors):
        if cur and size + t.numel() > _GROUP_ELEMENTS:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += t.numel()
    if cur:
        out.append(cur)
    return out


def make_optimizer(lr: float = 1e-4, weight_decay: float = 1e-2,
                   warmup: int = 100) -> AdamW:
    """The JAX package's optimizer (``diffusion.py:33-41``)."""
    return AdamW(lr=lr, weight_decay=weight_decay, warmup=warmup)


def diffusion_loss(unet, sched: sched_ops.DDIMSchedule,
                   latents: torch.Tensor, context: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """epsilon-prediction MSE (fp32) of ``unet`` on clean latents ``[B, h,
    w, 4]`` (NHWC, as the pipelines keep them) under ``context [B, L,
    C]``, at train timesteps ``t [B]`` drawn uniformly from ``generator``
    and noise drawn from it after them (the JAX package's split key), or
    injected."""
    b = latents.shape[0]
    if (t is None or noise is None) and generator is None:
        raise ValueError("diffusion_loss needs a generator for the draws "
                         "it is not given")
    if t is None:
        t = torch.randint(0, sched.num_train_timesteps, (b,),
                          generator=generator, device=latents.device)
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator,
                            device=latents.device, dtype=latents.dtype)
    t = t.to(latents.device, torch.long)
    noisy = sched_ops.add_noise(sched, latents, noise.to(latents.device), t)
    pred = unet(noisy.permute(0, 3, 1, 2), t, context)
    return torch.mean(torch.square(pred.permute(0, 2, 3, 1).float()
                                   - noise.to(latents.device)))


class TrainStep:
    """``step(state, latents, context, generator=None, *, t=None,
    noise=None) -> (state, loss)``, the JAX step's signature with the
    module bound and a generator for the key.  Its parts, in order, are
    public so that a caller can time them: :meth:`load` (masters into the
    module), :meth:`loss` (the forward), :meth:`grads` (the backward, fp32
    gradients of the trainable parameters) and :meth:`update` (clip,
    AdamW, the trainable parameters written back into the module)."""

    def __init__(self, unet, optimizer: AdamW,
                 scheduler_cfg: SchedulerConfig, *,
                 trainable_filter: Optional[Callable[[str], bool]] = None,
                 device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("make_train_step: no CUDA device; pass "
                               "device='cpu' to train on the CPU")
        got = unet.conv_in.weight.device
        if got.type != device.type or (device.index is not None
                                       and got != device):
            raise ValueError(f"make_train_step: the UNet is on {got}, the "
                             f"step on {device}")
        if unet.cfg.quantized:
            raise ValueError(
                "make_train_step: a W8A8 UNet has no gradient (quant_matmul "
                "raises under autograd; the JAX package's int8 leaves "
                "refuse jax.grad)")
        self.unet, self.optimizer = unet, optimizer
        self.sched = sched_ops.make_schedule(
            scheduler_cfg, scheduler_cfg.num_train_timesteps)
        self._params = dict(unet.named_parameters())
        self.trainable = [n for n in self._params
                          if trainable_filter is None or trainable_filter(n)]
        if not self.trainable:
            raise ValueError("make_train_step: the filter leaves no "
                             "parameter to train")
        keep = set(self.trainable)
        for n, p in self._params.items():
            p.requires_grad_(n in keep)

    def init_state(self) -> TrainState:
        """Step 0 from the module's parameters: fp32 masters (copies) and
        zero moments for the trainable ones only."""
        params = {n: p.detach().float().clone()
                  for n, p in self._params.items()}
        return TrainState(params, self.optimizer.init(
            {n: params[n] for n in self.trainable}), 0)

    @torch.no_grad()
    def load(self, state: TrainState, names=None) -> None:
        """Write the masters of ``names`` (default: all) into the module,
        cast to its dtype."""
        for n in self._params if names is None else names:
            self._params[n].copy_(state.params[n])

    def loss(self, latents, context, generator=None, *, t=None,
             noise=None) -> torch.Tensor:
        return diffusion_loss(self.unet, self.sched, latents, context,
                              generator, t=t, noise=noise)

    def grads(self, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Backward from ``loss``: the fp32 gradient of every trainable
        parameter (zeros where the loss does not reach one, as
        ``jax.grad`` gives), the module's ``.grad``s cleared."""
        loss.backward()
        out = {}
        for n in self.trainable:
            p = self._params[n]
            g = p.grad
            out[n] = (torch.zeros_like(p, dtype=torch.float32) if g is None
                      else g.float() if g.dtype != torch.float32 else g)
            p.grad = None
        return out

    def update(self, state: TrainState,
               grads: Mapping[str, torch.Tensor]) -> TrainState:
        self.optimizer.update(state.params, grads, state.opt_state)
        self.load(state, self.trainable)
        return TrainState(state.params, state.opt_state, state.step + 1)

    def __call__(self, state: TrainState, latents, context, generator=None,
                 *, t=None, noise=None):
        self.load(state)
        loss = self.loss(latents, context, generator, t=t, noise=noise)
        state = self.update(state, self.grads(loss))
        return state, loss.detach()


def make_train_step(unet, optimizer: AdamW, scheduler_cfg: SchedulerConfig,
                    *, trainable_filter: Optional[Callable[[str], bool]] = None,
                    device="cuda") -> TrainStep:
    """The JAX package's ``make_train_step`` (``diffusion.py:62-98``) for
    the port's UNet module on ``device`` (the card unless
    ``device='cpu'``); see :class:`TrainStep`."""
    return TrainStep(unet, optimizer, scheduler_cfg,
                     trainable_filter=trainable_filter, device=device)


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor],
               params: Mapping[str, torch.Tensor],
               decay: float = 0.9999) -> Dict[str, torch.Tensor]:
    """``e · decay + p · (1 − decay)`` for every entry of ``ema_params``
    (in place; returned).  Apply after each train step, serve from the
    EMA."""
    names = list(ema_params)
    e = [ema_params[n] for n in names]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [params[n].to(ema_params[n].dtype)
                            for n in names], alpha=1.0 - decay)
    return ema_params


class ShardedTrainStep:
    """A :class:`TrainStep` over a ('dp', 'tp') mesh; every rank makes one
    from its own copy of the step (the same UNet, seed and options) with
    :func:`shard_train_step`, which shards that UNet in place.  Rank 0
    calls it as the step, ``step(state, latents, context, generator=None,
    *, t=None, noise=None) -> (state, loss)``, with the whole batch (B a
    multiple of dp): it draws ``t`` and the noise for the whole batch
    where they are not given (as ``diffusion_loss`` draws them), sends
    each dp group its rows and runs group 0's; the other ranks, in
    ``parallel.worker.serve`` with this object registered, step their own
    state.  Rank 0's state holds rank 0's shards;
    :meth:`init_state`, :meth:`init_ema`, :meth:`ema_update` and
    :meth:`full` and :meth:`load` keep the ranks in step
    (``training/checkpoint.save_sharded`` writes the unsharded file,
    :meth:`load` reads it)."""

    # the name both sides register it under (one sharded step a mesh)
    name = "train"

    def __init__(self, step: TrainStep, mesh):
        self.step, self.mesh = step, mesh
        # {parameter name: (kind, dim)} of the tp-sharded parameters
        self.specs = mesh_lib.shard_specs(step.unet, mesh.tp)
        mesh_lib.shard_module(step.unet, mesh, inplace=True)
        step._params = dict(step.unet.named_parameters())
        keep = set(step.trainable)
        for n, p in step._params.items():
            p.requires_grad_(n in keep)
        self.state: Optional[TrainState] = None   # a worker's own
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        worker.register(mesh, self.name, self)

    def _call(self, method: str, own: tuple, others: list) -> list:
        return worker.dispatch(
            self.mesh, dict(kind="call", name=self.name, method=method),
            [own] + others)

    def init_state(self) -> TrainState:
        """Step 0 on every rank; returns rank 0's."""
        return self._call("_init", (True,), [(False,)] * (
            self.mesh.world - 1))[0]

    def _init(self, own: bool):
        state = self.step.init_state()
        if own:
            return state
        self.state = state

    def __call__(self, state: TrainState, latents, context, generator=None,
                 *, t=None, noise=None):
        return self._run("_step", state, latents, context, generator, t,
                         noise)

    def gradients(self, state: TrainState, latents, context, generator=None,
                  *, t=None, noise=None):
        """``(loss, grads)`` of the whole batch at ``state`` without an
        update: the dp-averaged gradients of rank 0's trainable shards (what
        the step clips and applies)."""
        return self._run("_grads_only", state, latents, context, generator,
                         t, noise)

    def _run(self, method, state, latents, context, generator, t, noise):
        b = latents.shape[0]
        dp = self.mesh.dp
        if b % dp:
            raise ValueError(f"batch {b} is not a multiple of dp={dp}")
        dev = latents.device
        if t is None:
            if generator is None:
                raise ValueError("a sharded step needs a generator for the "
                                 "draws it is not given")
            t = torch.randint(0, self.step.sched.num_train_timesteps, (b,),
                              generator=generator, device=dev)
        if noise is None:
            if generator is None:
                raise ValueError("a sharded step needs a generator for the "
                                 "draws it is not given")
            noise = torch.randn(latents.shape, generator=generator,
                                device=dev, dtype=latents.dtype)
        per = b // dp
        rows = []
        for r in range(self.mesh.world):
            a = (r // self.mesh.tp) * per
            rows.append((latents[a:a + per], context[a:a + per],
                         t[a:a + per], noise[a:a + per]))
        out = self._call(method, rows[0] + (state,),
                         [x + (None,) for x in rows[1:]])
        return out[0]

    def _mean_grads(self, st, latents, context, t, noise):
        """This rank's loss and gradients at ``st``, both averaged over dp
        (the whole batch's mean and its gradient)."""
        step, mesh = self.step, self.mesh
        step.load(st)
        loss = step.loss(latents, context, t=t, noise=noise)
        grads = step.grads(loss)
        names = list(grads)
        # the gradient of the whole batch's mean: the dp groups' mean
        for group in _groups(names, [grads[n] for n in names]):
            flat = torch.cat([grads[names[i]].reshape(-1) for i in group])
            collectives.all_reduce(mesh, flat, "dp")
            flat /= mesh.dp
            for i, part in zip(group, flat.split(
                    [grads[names[i]].numel() for i in group])):
                grads[names[i]].copy_(part.view_as(grads[names[i]]))
        loss = collectives.all_reduce(mesh, loss.detach().clone(), "dp") / mesh.dp
        return loss, grads

    def _grads_only(self, latents, context, t, noise, state):
        own = state is not None
        out = self._mean_grads(state if own else self.state, latents,
                               context, t, noise)
        return out if own else None

    def _step(self, latents, context, t, noise, state):
        own = state is not None
        st = state if own else self.state
        step, mesh = self.step, self.mesh
        loss, grads = self._mean_grads(st, latents, context, t, noise)
        names = list(grads)
        # global norm: each tp-sharded parameter's squares once over tp
        sq = [torch.zeros((), device=loss.device) for _ in range(2)]
        for n in names:
            sq[n in self.specs] += grads[n].float().square().sum()
        collectives.all_reduce(mesh, sq[1], "tp")
        norm = torch.sqrt(sq[0] + sq[1])
        step.optimizer.update(st.params, grads, st.opt_state, norm=norm)
        step.load(st, step.trainable)
        new = TrainState(st.params, st.opt_state, st.step + 1)
        if own:
            return new, loss
        self.state = new

    def init_ema(self, state: TrainState, names=None
                 ) -> Dict[str, torch.Tensor]:
        """An EMA of ``names`` (default: every parameter) started at the
        state's parameters, on every rank; returns rank 0's."""
        names = list(state.params if names is None else names)
        return self._call("_init_ema", (names, state),
                          [(names, None)] * (self.mesh.world - 1))[0]

    def _init_ema(self, names, state):
        own = state is not None
        params = (state if own else self.state).params
        ema = {n: params[n].clone() for n in names}
        if own:
            return ema
        self.ema = ema

    def ema_update(self, ema: Dict[str, torch.Tensor], state: TrainState,
                   decay: float = 0.9999) -> Dict[str, torch.Tensor]:
        """:func:`ema_update` on every rank's shards."""
        return self._call("_ema", (ema, state, decay),
                          [(None, None, decay)] * (self.mesh.world - 1))[0]

    def _ema(self, ema, state, decay):
        if ema is None:
            ema_update(self.ema, self.state.params, decay)
            return None
        return ema_update(ema, state.params, decay)

    def full(self, tree):
        """The unsharded copy of ``tree`` (rank 0's ``TrainState``, or a dict
        of its tensors by parameter name, such as an EMA; with ``"ema"``
        the workers' own EMA): each tp-sharded tensor gathered over the tp
        group of dp group 0, on rank 0."""
        kind = "state" if isinstance(tree, TrainState) else "ema"
        return self._call("_full", (tree, kind), [(None, kind)] * (
            self.mesh.world - 1))[0]

    def _full(self, tree, kind):
        own = tree is not None
        if not own:
            tree = self.state if kind == "state" else self.ema
        if kind == "state":
            opt = tree.opt_state
            out = TrainState(self._gather(tree.params), AdamWState(
                opt.count, self._gather(opt.mu), self._gather(opt.nu)),
                tree.step)
        else:
            out = self._gather(tree)
        return out if own else None

    def _gather(self, named: Mapping[str, torch.Tensor]):
        if named is None:
            return None
        mesh = self.mesh
        out = {}
        for n, t in named.items():
            if n in self.specs and mesh.dp_index == 0:
                kind, dim = self.specs[n]
                parts = collectives.all_gather(mesh, t, "tp", dim).chunk(
                    mesh.tp, dim)
                t = mesh_lib.unshard(list(parts), kind, dim)
            out[n] = t
        return out

    def load(self, path: str):
        """Every rank reads the unsharded checkpoint at ``path`` (written by
        ``training/checkpoint.save_sharded`` or by an unsharded run; the
        directory must be readable by every rank) and keeps its shards:
        the workers their state and EMA, rank 0 the returned tree (a
        ``TrainState``, or ``{"state", "ema"}``)."""
        return self._call("_load", (path, True), [(path, False)] * (
            self.mesh.world - 1))[0]

    def _load(self, path, own):
        from .checkpoint import load_checkpoint

        tree = load_checkpoint(path, device=self.mesh.device)
        state = tree["state"] if isinstance(tree, dict) else tree
        ema = tree.get("ema") if isinstance(tree, dict) else None
        state = self._shard(state)
        ema = None if ema is None else self._shard(ema)
        if own:
            return state if ema is None else {"state": state, "ema": ema}
        self.state, self.ema = state, ema

    def _shard(self, tree):
        """This rank's shards of an unsharded ``TrainState`` or dict of
        tensors by parameter name."""
        cut = lambda named: {  # noqa: E731
            n: (mesh_lib.shard_tensor(t, *self.specs[n], self.mesh.tp,
                                      self.mesh.tp_index)
                if n in self.specs else t) for n, t in named.items()}
        if isinstance(tree, TrainState):
            opt = tree.opt_state
            return TrainState(cut(tree.params), AdamWState(
                opt.count, cut(opt.mu), cut(opt.nu)), tree.step)
        return cut(tree)


def shard_train_step(step_fn: TrainStep, mesh=None):
    """The step unchanged without a mesh (or on a one-rank mesh); over a
    mesh, a :class:`ShardedTrainStep` (which shards the step's UNet in
    place), registered on this rank's mesh."""
    if mesh is None or mesh.world == 1:
        return step_fn
    if not isinstance(step_fn, TrainStep):
        raise TypeError("shard_train_step over several ranks takes a "
                        "TrainStep (make_train_step)")
    return ShardedTrainStep(step_fn, mesh)
