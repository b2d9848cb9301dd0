"""DDIM (with inversion), Euler-Ancestral and LCM samplers: the port of
``theatergen_tpu/ops/scheduler.py``.  The tables are built in numpy exactly
as there, so timesteps, alphas and sigmas match bit for bit.  A loop moves
a schedule's tables to its device once per run (:func:`device_tables`,
:meth:`Sampler.on`) and indexes them per step, so a step copies nothing
from the host; the steps run on tensors of any device and take their
noise explicitly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch

from ..config import SchedulerConfig


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Static schedule tables (host numpy).

    ``timesteps`` [S] int32 descending; ``alphas_cumprod`` [T] float32;
    ``alpha_prod`` [S] = alphas_cumprod[timesteps]; ``alpha_prod_prev`` [S]
    the alpha at the next loop position, last entry the final alpha."""

    timesteps: np.ndarray
    alphas_cumprod: np.ndarray
    alpha_prod: np.ndarray
    alpha_prod_prev: np.ndarray
    num_train_timesteps: int
    init_noise_sigma: float = 1.0
    prediction_type: str = "epsilon"

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def betas_for_schedule(cfg: SchedulerConfig) -> np.ndarray:
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                           cfg.num_train_timesteps, dtype=np.float64) ** 2
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end,
                           cfg.num_train_timesteps, dtype=np.float64)
    raise ValueError(f"unknown beta schedule {cfg.beta_schedule!r}")


def alphas_cumprod_for(cfg: SchedulerConfig) -> np.ndarray:
    acp = np.cumprod(1.0 - betas_for_schedule(cfg), axis=0)
    if cfg.rescale_zero_terminal_snr:
        # arXiv 2305.08891 alg. 1: terminal step at exactly zero SNR
        s = np.sqrt(acp)
        s0, sT = s[0], s[-1]
        s = (s - sT) * s0 / (s0 - sT)
        acp = s ** 2
    return acp


def uniform_timesteps(cfg: SchedulerConfig, num_steps: int) -> np.ndarray:
    """Diffusers-style leading-spaced timesteps with ``steps_offset``."""
    ratio = cfg.num_train_timesteps // num_steps
    ts = (np.arange(num_steps) * ratio).round()[::-1].astype(np.int64)
    ts = ts + cfg.steps_offset
    return np.clip(ts, 0, cfg.num_train_timesteps - 1).astype(np.int32)


def fast_timesteps(cfg: SchedulerConfig, num_steps: int,
                   fast_after_steps: int, fast_rate: int) -> np.ndarray:
    """First ``fast_after_steps`` timesteps kept, the rest strided."""
    ts = uniform_timesteps(cfg, num_steps)
    if fast_after_steps >= len(ts) - 1:
        return ts
    return np.concatenate([ts[:fast_after_steps],
                           ts[fast_after_steps + 1::fast_rate]])


def make_schedule(cfg: SchedulerConfig, num_steps: int, *,
                  fast_after_steps: Optional[int] = None,
                  fast_rate: int = 2) -> DDIMSchedule:
    acp = alphas_cumprod_for(cfg).astype(np.float32)
    if fast_after_steps is not None:
        timesteps = fast_timesteps(cfg, num_steps, fast_after_steps,
                                   fast_rate)
    else:
        timesteps = uniform_timesteps(cfg, num_steps)
    final_alpha = np.float32(1.0) if cfg.set_alpha_to_one else acp[0]
    return DDIMSchedule(
        timesteps=timesteps,
        alphas_cumprod=acp,
        alpha_prod=acp[timesteps],
        alpha_prod_prev=np.concatenate([acp[timesteps[1:]], [final_alpha]]),
        num_train_timesteps=cfg.num_train_timesteps,
        prediction_type=cfg.prediction_type,
    )


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """A schedule's per-step tables as tensors on one device, made once per
    run, so a loop reads its step's values by indexing and copies nothing
    from the host (a host-to-device copy waits for the stream)."""

    timesteps: torch.Tensor        # [S] int64
    alpha_prod: torch.Tensor       # [S] float32
    alpha_prod_prev: torch.Tensor  # [S] float32
    prediction_type: str = "epsilon"


def device_tables(sched: DDIMSchedule, device) -> DeviceTables:
    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return DeviceTables(put(sched.timesteps, torch.long),
                        put(sched.alpha_prod, torch.float32),
                        put(sched.alpha_prod_prev, torch.float32),
                        sched.prediction_type)


def x0_eps_from_pred(prediction_type: str, a_t: torch.Tensor,
                     model_output: torch.Tensor, sample: torch.Tensor):
    """(x0, eps) from the model output under a given parameterization."""
    sq_a = torch.sqrt(a_t)
    sq_1a = torch.sqrt(1.0 - a_t)
    if prediction_type == "epsilon":
        eps = model_output
        x0 = (sample - sq_1a * eps) / sq_a
    elif prediction_type == "v_prediction":
        x0 = sq_a * sample - sq_1a * model_output
        eps = sq_a * model_output + sq_1a * sample
    elif prediction_type == "sample":
        x0 = model_output
        eps = (sample - sq_a * x0) / sq_1a
    else:
        raise ValueError(f"unknown prediction_type {prediction_type!r}")
    return x0, eps


def pred_original(sched: DDIMSchedule, model_output: torch.Tensor, i,
                  sample: torch.Tensor) -> torch.Tensor:
    """x0 predicted from the model output at loop position ``i`` (an int
    or a 0-dim tensor)."""
    a_t = torch.as_tensor(sched.alpha_prod, device=sample.device)[i]
    return x0_eps_from_pred(sched.prediction_type, a_t.to(sample.dtype),
                            model_output, sample)[0]


def ddim_step(tables: DeviceTables, model_output: torch.Tensor, i: int,
              sample: torch.Tensor, *, eta: float = 0.0,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One DDIM update x_t → x_{t_prev} at loop position ``i`` (diffusers
    ``DDIMScheduler.step`` with ``clip_sample=False``), the alphas indexed
    from ``tables`` (:func:`device_tables`, on ``sample``'s device)."""
    a_t = tables.alpha_prod[i].to(sample.dtype)
    a_prev = tables.alpha_prod_prev[i].to(sample.dtype)
    x0, eps = x0_eps_from_pred(tables.prediction_type, a_t, model_output,
                               sample)
    if eta <= 0.0:
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
    if noise is None:
        raise ValueError("eta > 0 requires noise")
    sigma = eta * torch.sqrt(
        (1.0 - a_prev) / (1.0 - a_t) * (1.0 - a_t / a_prev))
    prev = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev - sigma ** 2) * eps
    return prev + sigma * noise


def make_inversion_schedule(cfg: SchedulerConfig,
                            num_steps: int) -> DDIMSchedule:
    """Ascending timesteps for DDIM inversion: the i-th inverse step maps
    x at the previous (smaller) timestep to x at ``timesteps[i]``, so
    ``alpha_prod`` holds the target alpha and ``alpha_prod_prev`` the
    source one (``alphas_cumprod[0]`` for the clean first source)."""
    acp = alphas_cumprod_for(cfg).astype(np.float32)
    ts = uniform_timesteps(cfg, num_steps)[::-1].copy()
    src = np.concatenate([[0], ts[:-1]])
    alpha_src = np.where(np.arange(len(ts)) == 0, acp[0], acp[src])
    return DDIMSchedule(
        timesteps=ts, alphas_cumprod=acp, alpha_prod=acp[ts],
        alpha_prod_prev=alpha_src.astype(np.float32),
        num_train_timesteps=cfg.num_train_timesteps,
        prediction_type=cfg.prediction_type)


def ddim_inverse_step(tables: DeviceTables, model_output: torch.Tensor,
                      i: int, sample: torch.Tensor) -> torch.Tensor:
    """One DDIM inversion update (ascending schedule of
    :func:`make_inversion_schedule`)."""
    a_t = tables.alpha_prod[i].to(sample.dtype)
    a_src = tables.alpha_prod_prev[i].to(sample.dtype)
    x0, eps = x0_eps_from_pred(tables.prediction_type, a_src, model_output,
                               sample)
    return torch.sqrt(a_t) * x0 + torch.sqrt(1.0 - a_t) * eps


def add_noise(sched: DDIMSchedule, sample: torch.Tensor,
              noise: torch.Tensor, t) -> torch.Tensor:
    """Forward-process noising at train timestep ``t``, an int or a tensor
    whose entries broadcast over ``sample``'s leading axes."""
    acp = torch.as_tensor(sched.alphas_cumprod, device=sample.device,
                          dtype=sample.dtype)
    a = acp[torch.as_tensor(t, dtype=torch.long, device=sample.device)]
    a = a.reshape(a.shape + (1,) * (sample.ndim - a.ndim))
    return torch.sqrt(a) * sample + torch.sqrt(1.0 - a) * noise


def guidance_step_scale(sched: DDIMSchedule, i: int) -> np.float32:
    """Gradient-descent scale of latent guidance at loop position ``i``:
    ``sqrt(1 - alpha_prod_t)`` (the reference's DDIM scale,
    ``models/pipelines.py:106-119``), in fp32."""
    return np.sqrt(np.float32(1.0) - sched.alpha_prod[i])


# ---------------------------------------------------------------------------
# Euler-Ancestral (SDXL's sampler)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EulerAncestralSchedule:
    """Sigma-parameterized ancestral Euler tables (host numpy).

    ``timesteps`` [S] int32 descending; ``sigmas`` [S+1] float32 with the
    terminal 0 appended.  Latents start at ``init_noise_sigma = sigmas[0]``
    and model inputs are scaled by ``1/sqrt(sigma^2+1)`` each step
    (diffusers ``EulerAncestralDiscreteScheduler`` semantics)."""

    timesteps: np.ndarray
    sigmas: np.ndarray
    num_train_timesteps: int
    prediction_type: str = "epsilon"

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])

    @property
    def init_noise_sigma(self) -> float:
        return float(self.sigmas[0])


def make_euler_ancestral_schedule(cfg: SchedulerConfig,
                                  num_steps: int) -> EulerAncestralSchedule:
    acp = alphas_cumprod_for(cfg).astype(np.float64)
    # zero-SNR rescale drives acp[-1] to exactly 0; leading-spaced timesteps
    # never index it, but keep the table finite
    all_sigmas = np.sqrt((1.0 - acp) / np.maximum(acp, 1e-24))
    ts = uniform_timesteps(cfg, num_steps)
    sigmas = np.concatenate([all_sigmas[ts], [0.0]]).astype(np.float32)
    return EulerAncestralSchedule(
        timesteps=ts, sigmas=sigmas,
        num_train_timesteps=cfg.num_train_timesteps,
        prediction_type=cfg.prediction_type,
    )


@dataclasses.dataclass(frozen=True)
class EATables:
    """An Euler-Ancestral schedule's tables on one device: ``timesteps``
    [S] int64 and ``sigmas`` [S+1] float32."""

    timesteps: torch.Tensor
    sigmas: torch.Tensor
    prediction_type: str = "epsilon"


def ea_device_tables(sched: EulerAncestralSchedule, device) -> EATables:
    return EATables(
        torch.as_tensor(sched.timesteps, dtype=torch.long, device=device),
        torch.as_tensor(sched.sigmas, dtype=torch.float32, device=device),
        sched.prediction_type)


def ea_scale_model_input(tables: EATables, sample: torch.Tensor,
                         i: int) -> torch.Tensor:
    sigma = tables.sigmas[i].to(sample.dtype)
    return sample / torch.sqrt(sigma ** 2 + 1.0)


def ea_step(tables: EATables, model_output: torch.Tensor, i: int,
            sample: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One ancestral Euler update of the raw (unscaled) latent ``sample``
    at loop position ``i``, the sigmas indexed from ``tables``
    (:func:`ea_device_tables`); ``noise`` is the step's unit-normal
    draw."""
    s_from = tables.sigmas[i].to(sample.dtype)
    s_to = tables.sigmas[i + 1].to(sample.dtype)
    if tables.prediction_type == "epsilon":
        x0 = sample - s_from * model_output
    elif tables.prediction_type == "v_prediction":
        x0 = (sample / (s_from ** 2 + 1.0)
              - model_output * s_from / torch.sqrt(s_from ** 2 + 1.0))
    elif tables.prediction_type == "sample":
        x0 = model_output
    else:
        raise ValueError(
            f"unknown prediction_type {tables.prediction_type!r}")
    var = torch.clamp(s_from ** 2 - s_to ** 2, min=0.0)
    s_up = torch.sqrt(s_to ** 2 * var / torch.clamp(s_from ** 2, min=1e-12))
    s_down = torch.sqrt(torch.clamp(s_to ** 2 - s_up ** 2, min=0.0))
    derivative = (sample - x0) / torch.clamp(s_from, min=1e-12)
    return sample + derivative * (s_down - s_from) + noise * s_up


# ---------------------------------------------------------------------------
# LCM (Latent Consistency Models, LCM-LoRA)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LCMSchedule:
    """Latent Consistency Model tables (host numpy): guidance-free, one
    UNet evaluation a step, 4-8 steps in place of 50 once an LCM(-LoRA)
    checkpoint is merged (``models/lora.py``).

    ``timesteps`` [S] int32 descending; ``alpha_prod`` [S] and
    ``alpha_prod_prev`` [S] (the next loop position's, the last entry
    ``alphas_cumprod[0]``) float32; ``c_skip`` and ``c_out`` [S] float32,
    the boundary-condition weights at ``timesteps · timestep_scaling``."""

    timesteps: np.ndarray
    alpha_prod: np.ndarray
    alpha_prod_prev: np.ndarray
    c_skip: np.ndarray
    c_out: np.ndarray
    timestep_scaling: float = 10.0
    sigma_data: float = 0.5
    init_noise_sigma: float = 1.0

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def make_lcm_schedule(cfg: SchedulerConfig, num_steps: int,
                      original_inference_steps: int = 50,
                      timestep_scaling: float = 10.0,
                      sigma_data: float = 0.5) -> LCMSchedule:
    """diffusers ``LCMScheduler.set_timesteps``: the distillation grid is
    ``arange(1, K+1)·(T/K) − 1`` (K = ``original_inference_steps``);
    sampling picks ``floor(linspace(0, K, num_steps, endpoint=False))``
    indices into the reversed grid."""
    t_train = cfg.num_train_timesteps
    skipping = t_train // original_inference_steps
    origin = np.arange(1, original_inference_steps + 1) * skipping - 1
    idx = np.floor(np.linspace(0, len(origin), num_steps,
                               endpoint=False)).astype(np.int64)
    ts = origin[::-1][idx].astype(np.int32)
    acp = alphas_cumprod_for(cfg)
    # the boundary-condition weights in fp32, as the JAX step computes them
    f32 = np.float32
    scaled_t = ts.astype(f32) * f32(timestep_scaling)
    sd2 = f32(sigma_data ** 2)
    return LCMSchedule(
        timesteps=ts,
        alpha_prod=acp[ts].astype(f32),
        alpha_prod_prev=np.concatenate([acp[ts[1:]], [acp[0]]]).astype(f32),
        c_skip=(sd2 / (scaled_t ** 2 + sd2)).astype(f32),
        c_out=(scaled_t / np.sqrt(scaled_t ** 2 + sd2)).astype(f32),
        timestep_scaling=timestep_scaling, sigma_data=sigma_data)


@dataclasses.dataclass(frozen=True)
class LCMTables:
    """An LCM schedule's per-step tables on one device."""

    timesteps: torch.Tensor        # [S] int64
    alpha_prod: torch.Tensor       # [S] float32
    alpha_prod_prev: torch.Tensor  # [S] float32
    c_skip: torch.Tensor           # [S] float32
    c_out: torch.Tensor            # [S] float32


def lcm_device_tables(sched: LCMSchedule, device) -> LCMTables:
    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return LCMTables(put(sched.timesteps, torch.long), put(sched.alpha_prod),
                     put(sched.alpha_prod_prev), put(sched.c_skip),
                     put(sched.c_out))


def lcm_step(tables: LCMTables, model_output: torch.Tensor, i: int,
             sample: torch.Tensor, noise: Optional[torch.Tensor],
             last: bool) -> torch.Tensor:
    """One consistency step: x0 from eps, the boundary-condition blend,
    then re-noised to the next grid timestep with ``noise`` (the step's
    unit-normal draw), except on the ``last`` step, which returns the
    blend and needs no noise.  fp32 inside, ``sample``'s dtype out."""
    a_t, a_prev = tables.alpha_prod[i], tables.alpha_prod_prev[i]
    x = sample.float()
    eps = model_output.float()
    x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    denoised = tables.c_out[i] * x0 + tables.c_skip[i] * x
    if last:
        return denoised.to(sample.dtype)
    if noise is None:
        raise ValueError("an LCM step before the last needs noise")
    out = (torch.sqrt(a_prev) * denoised
           + torch.sqrt(1.0 - a_prev) * noise.float())
    return out.to(sample.dtype)


# ---------------------------------------------------------------------------
# Sampler: one interface over DDIM, Euler-Ancestral and LCM for the loops
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sampler:
    """The denoise loops' stepping interface (host tables); ``kind``
    selects the math.  A loop calls :meth:`on` once per run and steps the
    returned :class:`DeviceSampler`."""

    kind: str                              # "ddim" | "euler_ancestral" | "lcm"
    ddim: Optional[DDIMSchedule] = None
    ea: Optional[EulerAncestralSchedule] = None
    lcm: Optional[LCMSchedule] = None

    @property
    def schedule(self):
        return self.ddim or self.ea or self.lcm

    @property
    def num_steps(self) -> int:
        return self.schedule.num_steps

    @property
    def timesteps(self) -> np.ndarray:
        return self.schedule.timesteps

    @property
    def init_noise_sigma(self) -> float:
        return float(self.schedule.init_noise_sigma)

    @property
    def needs_noise(self) -> bool:
        """Whether its steps draw noise (ancestral and consistency steps)."""
        return self.kind in ("euler_ancestral", "lcm")

    def draws(self, i: int) -> bool:
        """Whether step ``i`` takes noise: every Euler-Ancestral step, and
        every LCM step but the last, which returns the denoised blend."""
        return self.needs_noise and not (self.kind == "lcm"
                                         and i == self.num_steps - 1)

    def guidance_step_scale(self, i: int) -> np.float32:
        """Latent guidance's gradient scale at loop position ``i``:
        ``sqrt(1 - alpha)`` for DDIM and LCM, ``sigma²`` for
        Euler-Ancestral (fp32, from the host tables)."""
        if self.kind == "euler_ancestral":
            return self.ea.sigmas[i] ** 2
        if self.kind == "lcm":
            return np.sqrt(np.float32(1.0) - self.lcm.alpha_prod[i])
        return guidance_step_scale(self.ddim, i)

    def on(self, device) -> "DeviceSampler":
        if self.kind == "euler_ancestral":
            tables = ea_device_tables(self.ea, device)
        elif self.kind == "lcm":
            tables = lcm_device_tables(self.lcm, device)
        else:
            tables = device_tables(self.ddim, device)
        return DeviceSampler(self.kind, self.num_steps, tables)


@dataclasses.dataclass(frozen=True)
class DeviceSampler:
    """A :class:`Sampler`'s tables on one device, made once per run."""

    kind: str
    num_steps: int
    tables: Union[DeviceTables, EATables, LCMTables]

    @property
    def timesteps(self) -> torch.Tensor:
        return self.tables.timesteps

    def scale_model_input(self, sample: torch.Tensor,
                          i: int) -> torch.Tensor:
        if self.kind == "euler_ancestral":
            return ea_scale_model_input(self.tables, sample, i)
        return sample

    def guidance_step_scale(self, i: int) -> torch.Tensor:
        """:meth:`Sampler.guidance_step_scale` from the device tables: a
        0-dim fp32 tensor, so a guided step copies nothing from the host."""
        if self.kind == "euler_ancestral":
            return self.tables.sigmas[i] ** 2
        return torch.sqrt(1.0 - self.tables.alpha_prod[i])

    def step(self, model_output: torch.Tensor, i: int, sample: torch.Tensor,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update at loop position ``i``; ``noise`` is the step's
        unit-normal draw, which the ancestral and consistency steps need
        (not LCM's last step) and DDIM ignores."""
        if self.kind == "euler_ancestral":
            if noise is None:
                raise ValueError("an Euler-Ancestral step needs noise")
            return ea_step(self.tables, model_output, i, sample,
                           noise.to(sample.dtype))
        if self.kind == "lcm":
            return lcm_step(self.tables, model_output, i, sample, noise,
                            last=i == self.num_steps - 1)
        return ddim_step(self.tables, model_output, i, sample)


SAMPLER_KINDS = ("ddim", "euler_ancestral", "lcm")


def make_sampler(cfg: SchedulerConfig, num_steps: int, *,
                 kind: str = "ddim", fast_after_steps: Optional[int] = None,
                 fast_rate: int = 2) -> Sampler:
    if kind == "euler_ancestral":
        return Sampler(kind=kind,
                       ea=make_euler_ancestral_schedule(cfg, num_steps))
    if kind == "lcm":
        return Sampler(kind=kind, lcm=make_lcm_schedule(cfg, num_steps))
    if kind != "ddim":
        raise ValueError(f"unknown sampler {kind!r}; expected one of "
                         f"{SAMPLER_KINDS}")
    return Sampler(kind="ddim", ddim=make_schedule(
        cfg, num_steps, fast_after_steps=fast_after_steps,
        fast_rate=fast_rate))


def cfg_cutoff_steps(num_steps: int, fraction: Optional[float]) -> int:
    """Steps to run with full CFG before switching to cond-only:
    ``None`` (or ≥ 1) keeps CFG for every step; otherwise
    ``ceil(fraction · num_steps)`` clamped to [1, num_steps], so guidance
    always shapes the high-noise start."""
    if fraction is None or fraction >= 1.0:
        return num_steps
    return max(1, min(num_steps, int(math.ceil(fraction * num_steps))))
