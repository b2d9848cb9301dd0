"""DDIM and Euler-Ancestral schedulers: the port of those parts of
``theatergen_tpu/ops/scheduler.py``.  The tables are built in numpy exactly
as there, so timesteps, alphas and sigmas match bit for bit; the steps run
on tensors of any device and take their noise explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


def _sigma(sched: EulerAncestralSchedule, i: int,
           like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(sched.sigmas[i]), dtype=like.dtype,
                        device=like.device)


def ea_scale_model_input(sched: EulerAncestralSchedule, sample: torch.Tensor,
                         i: int) -> torch.Tensor:
    sigma = _sigma(sched, i, sample)
    return sample / torch.sqrt(sigma ** 2 + 1.0)


def ea_step(sched: EulerAncestralSchedule, model_output: torch.Tensor,
            i: int, sample: torch.Tensor,
            noise: torch.Tensor) -> torch.Tensor:
    """One ancestral Euler update of the raw (unscaled) latent ``sample``
    at loop position ``i``; ``noise`` is the step's unit-normal draw."""
    s_from = _sigma(sched, i, sample)
    s_to = _sigma(sched, i + 1, sample)
    if sched.prediction_type == "epsilon":
        x0 = sample - s_from * model_output
    elif sched.prediction_type == "v_prediction":
        x0 = (sample / (s_from ** 2 + 1.0)
              - model_output * s_from / torch.sqrt(s_from ** 2 + 1.0))
    elif sched.prediction_type == "sample":
        x0 = model_output
    else:
        raise ValueError(
            f"unknown prediction_type {sched.prediction_type!r}")
    var = torch.clamp(s_from ** 2 - s_to ** 2, min=0.0)
    s_up = torch.sqrt(s_to ** 2 * var / torch.clamp(s_from ** 2, min=1e-12))
    s_down = torch.sqrt(torch.clamp(s_to ** 2 - s_up ** 2, min=0.0))
    derivative = (sample - x0) / torch.clamp(s_from, min=1e-12)
    return sample + derivative * (s_down - s_from) + noise * s_up
