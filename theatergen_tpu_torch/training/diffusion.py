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
from ..parallel.driver import refuse_mesh

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
               state: AdamWState) -> float:
        """One step over the parameters named in ``grads``, in place on
        ``params`` and ``state`` (whose count advances); the gradients are
        consumed (clipped in place).  Returns the rate it used.  No host
        synchronisation: the clipping decision stays on the device."""
        names = list(grads)
        g = [grads[n] for n in names]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
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


def shard_train_step(step_fn, mesh=None):
    """The step unchanged on one device; a mesh raises until the
    multi-rank half of ROADMAP §1 item 5 lands."""
    refuse_mesh(mesh)
    return step_fn
