"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # build, check, time, run all paths
    python3 chip_smoke.py --profile  # also kernel-time breakdowns and the
                                     # GroupNorm A/B

Phases, in order (any failure exits non-zero):
  1. the card's name and power limit;
  2. build every kernel of ``theatergen_tpu_torch/csrc`` with nvcc (sm_90a),
     one process per source, all at once; derive each evaluation kind's
     launches (CFG or cond-only, full or DeepCache-shallow; ControlNet)
     from the routing functions (``eval_launches``) and hold them to the
     constants of the earlier paths;
  3. hold each kernel against its plain PyTorch version (fp32 from the same
     bf16 inputs) at every shape its main paths give it (GroupNorm also with
     and without SiLU and with a large-mean input; flash on each of its
     four routes' counters, d = 160 and Sq != Sk included, and sequence
     parallelism's query shards, concatenated, against the unsharded call),
     batch-1 (cond-only) shapes included;
  4. time kernel, plain version and a library yardstick at those shapes,
     printing each flash, FF, geglu_matmul, group_norm and quant_matmul
     launch plan (cluster size, rows per CTA or cluster, keys per K/V tile,
     splits, ring stages; group_norm's width, share and route), group_norm
     also cold (its input read from device memory, not L2), and the host
     µs per call of the flash, FF, geglu_matmul, quant_matmul and
     group_norm wrappers at one or two path shapes each;
  4b. each kernel's gradient (``grad_gate_phase``, latent guidance's
     batch-1 shapes): the wrapper under autograd launches its kernel once
     forward, within the bound of its plain version, and none backward,
     whose gradients equal the plain version's bit for bit;
  5. SD1.5: ``init_bundle(sd15_config())``, one full-size UNet evaluation
     with the kernels against the same UNet under ``plain_path()``, then
     ``Text2Img(bundle, num_steps=50)`` on three prompts at 512 px, CFG 7.5;
     then one request with DeepCache every 3rd step, and one 4-step LCM
     request on a copy of the UNet with a seeded synthetic LoRA (rank 64,
     every attention projection and FF linear) merged by
     ``apply_lora_unet``;
  6. W8A8 SD1.5: the SD1.5 bundle freed, ``init_bundle`` of
     ``sd15_config()`` with ``quantized=True`` (the seeded float weights
     quantized), the same UNet check at ``THEATERGEN_FUSED_INT8`` "1",
     every quantized site of one evaluation bit for bit against the
     kernel's plain version, the error against the float SD1.5 UNet of the
     same seed, then
     ``Text2Img(bundle, num_steps=50)`` on three prompts with the switch at
     "1" (every quantized linear through ``quant_matmul``) and one at "0";
     then the UNet check and one request under ``THEATERGEN_FLASH_BSHD=1``
     (flash's row-3 route) and under ``THEATERGEN_FLASH_FLAT=0`` (row 4);
  7. SDXL: the W8A8 bundle freed, ``init_bundle(sdxl_config())``, the same
     UNet check, then ``Text2ImgXL(bundle, num_steps=30)`` on two prompts at
     1024 px, Euler-Ancestral, CFG 7.5, and one 4-step LCM request (the
     config's ``scheduler_type`` replaced);
  7b. the SDXL turn's models: ``init_bundle(sdxl_config(), with_ip=True,
     with_vision=True, with_t2i_adapter=True)``, the T2I-Adapter's
     features of a seeded 1024² hint, the XL IP UNet with pooled text,
     time ids and those features as ``level_residuals`` against
     ``plain_path()``, its wall and device ms per evaluation beside the
     base UNet's and its host-side op table, and 30-step ``Text2ImgXL``
     requests with and without the hint in turns; then a guided XL
     character request (``XL_GUIDED_STEPS`` Euler-Ancestral steps, every
     one guided) beside the unguided one from the same draws;
  8. the IP-Adapter character pass:
     ``init_bundle(sd15_config(), with_ip=True, with_vision=True)``, the IP
     UNet with the kernels against ``plain_path()`` (``THEATERGEN_FUSED_GN``
     at "1"), ``encode_ip_image`` of a seeded 512² image, ``ip_context``,
     then ``make_character_pipeline(bundle, 50, use_ip=True,
     capture_ref_attn=True)`` requests at ip_scale 0.4 and 0.0 with the
     switch at "1", and one at 0.4 with the switch at "0"; then the W8A8
     character pass (``sd15_config()`` with ``unet.quantized``,
     ``with_ip=True, with_vision=True``, ``THEATERGEN_FUSED_INT8`` at
     "1"): its IP UNet against ``plain_path()`` and within
     W8A8_FLOAT_BOUND of the float IP UNet, and one request;
  9. the back half of a turn at 512 px:
     ``init_bundle(sd15_config(), with_ip=True, with_vision=True,
     with_controlnet=True)``, the ControlNet and the IP UNet with its
     residuals each against ``plain_path()``, two character requests
     (ip_scale 0.4 and 0.0), their masks by ``theater._attn_mask_fallback``
     from the step-mean reference maps, ``theater._compose_program``
     (alignment, composition, collage, DoG lineart), then a final request:
     the overall prompt, ``ip_context`` with the first character's image,
     ``make_final_pipeline(bundle, 50)`` at ``frozen_steps`` 25 and
     ip_scale 0.1, and the decode; the device time of one final-pass
     evaluation, with the FF and flash kernels' shares of it (also at
     768 px); and one final-pass evaluation under
     ``THEATERGEN_FLASH_BSHD=1``, whose launches stay on the packed route;
     then DeepCache (``deepcache_phase``): the IP UNet's shallow evaluation
     from the cache of a full one, held to it and to ``plain_path()``, the
     launches of every evaluation kind, and its device and wall ms beside
     a full evaluation's;
 10. the same at 768 px (the bundle's config with ``pipeline.height`` and
     ``width`` replaced, one character), where level-0 self-attention runs
     9216 tokens: the flash kernel's long route; then the check and one
     final request under ``THEATERGEN_FLASH_BSHD=1`` (row 3) and under
     ``THEATERGEN_FLASH_FLAT16K=0`` (row 4);
 11. a whole story dialogue through the CLI, ``cli.generate.main``: the 4
     turns of dialogue_0 of data/sample/story.json at 512 px, 50 steps,
     its own random-weight bundle, output tree and character DB; each
     turn's launches against its character attempts; then latent guidance
     (``guided_path``): the energy's gradient through the SD1.5 IP UNet
     with the kernels against ``plain_path()`` and an fp32 copy, one
     guidance iteration's times, and dialogue_0 with ``--guidance``, each
     turn's launches with one cond-only evaluation per recorded
     iteration, its images other than the unguided run's; then the same with
     the CLI's knobs (TURN_KNOBS): ``--deepcache 3 --cfg_cutoff 0.5
     --cn_interval 2``, ``--scheduler lcm`` at 4 steps with ``--profile``
     (its trace checked on disk), and Euler-Ancestral with v-prediction
     and zero terminal SNR at 30 steps; then the SDXL
     dialogue, ``--sd_version xl --box_canvas 512``: 1024 px, 30
     Euler-Ancestral steps, the T2I-Adapter in place of the ControlNet,
     each turn's launches against its attempts × the XL character request
     plus one XL final request;
 12. the checkpoint-loaded turn (``checkpoint_path``): a synthetic
     full-width SD1.5 checkpoint directory in the published names (fp16
     UNet, VAE, text tower, ControlNet, ViT-H and ``ip-adapter_sd15.bin``;
     fp32 sam-vit-base and lineart annotator) under build/, its bytes and
     write seconds; ``load_bundle`` against the fp16-rounded source bit for
     bit, a snapshot round trip bit for bit, both cold starts timed; the
     loaded IP UNet against ``plain_path()``; SAM at 1024² and the
     annotator at 512² timed, launching no port kernel (the annotator
     also on cuDNN's default algorithms: its time and how far two calls
     part there; on the deterministic ones two calls must be equal); then
     dialogue_0 through the CLI with ``--weights``, with ``--weights
     --snapshot`` (saved) and with ``--snapshot`` (loaded), each under the
     turn gates,
     SAM run once per kept character, the loaded run's images equal to
     the first run's bit for bit; the directory deleted.
Every launch counter is set to 0 just before each request (or turn) and
read just after it, and must equal the launches per request of each
kernel: the constants of the SD1.5, W8A8 and SDXL requests under the
GroupNorm switch's default, and elsewhere ``request_want`` over the
request's step plan.
The script sets flash's switches itself and refuses to start when one is
set in the environment.  Then one
JSON line of kernel records and, last, the device line.  ``--profile``
adds the device time by kernel of one UNet evaluation of each model (the
W8A8 UNet at "1" too) and the GroupNorm A/B: device ms per evaluation of
both UNets, request pairs of the character pass and SDXL, and host ms per
evaluation and per norm layer.
Needs a CUDA device; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from unittest import mock

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from theatergen_tpu_torch import _build
from theatergen_tpu_torch import theater
from theatergen_tpu_torch.config import sd15_config, sdxl_config
from theatergen_tpu_torch.models.layers import (GroupNorm, QuantLinear,
                                                 plain_path)
from theatergen_tpu_torch.models import t2i_adapter
from theatergen_tpu_torch.models.lora import apply_lora_unet
from theatergen_tpu_torch.ops.attention import multi_head_attention
from theatergen_tpu_torch.ops import flash_attention as fa
from theatergen_tpu_torch.ops import geometry
from theatergen_tpu_torch.ops import lineart as lineart_ops
from theatergen_tpu_torch.ops import geglu_matmul as gg
from theatergen_tpu_torch.ops import groupnorm as gn
from theatergen_tpu_torch.ops import quant as qz
from theatergen_tpu_torch.ops import quant_matmul as qm
from theatergen_tpu_torch.ops import recompute
from theatergen_tpu_torch.perception import sam as sam_lib
from theatergen_tpu_torch.perception.sam_hf import SamHFConfig
from theatergen_tpu_torch.pipelines import character, final, sd, sdxl
from theatergen_tpu_torch.pipelines import guidance as guidance_lib
from theatergen_tpu_torch.pipelines.bundle import (build_lineart, build_sam,
                                                   init_bundle)
from theatergen_tpu_torch.utils import png

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# the kernels' outputs are bf16: 8 mantissa bits round at ~4e-3 relative
TOL = 1e-2
# inputs that a cold timing rotates through: over twice the H100's 50 MB L2
COLD_BYTES = 100e6
SD15, SDXL, CHAR = "sd15_512", "sdxl_1024", "sd15_512_ip"
W8A8 = "sd15_512_w8a8"
# the back half of a turn: the final pass (IP UNet + ControlNet) at 512 and
# 768 px, and the character pass at 768 px
FINAL, FINAL_768, CHAR_768 = "sd15_512_final", "sd15_768_final", "sd15_768_ip"
# kernel shapes of models no request here runs: SD1.5's level 2 on a
# 1024-px canvas (d = 160), and the 768-px final pass's level 0 split over
# 2 or 4 sequence-parallel ranks (one card runs each rank's shard)
SD15_1024, SP2_768, SP4_768 = "sd15_1024", "sd15_768_sp2", "sd15_768_sp4"
# a whole story turn through the CLI (dialogue_0 of data/sample/story.json)
TURN = "sd15_512_turn"
# the SDXL turn (--sd_version xl): the XL IP UNet of the character pass,
# the final pass on it with the T2I-Adapter's features (no ControlNet), a
# Text2ImgXL request with a hint, and dialogue_0 through the CLI at 1024 px
XL_CHAR, XL_FINAL = "sdxl_1024_ip", "sdxl_1024_final"
XL_HINT, XL_TURN = "sdxl_1024_hint", "sdxl_1024_turn"
# the checkpoint-loaded story turn: a synthetic SD1.5 checkpoint directory
# (the bundle of seed 0, SAM and the annotator drawn from CKPT_SEED)
CKPT, CKPT_SEED = "sd15_512_checkpoint", 12
# CMIGBench authors its layout boxes on a 512² canvas; the XL turn scales
# them to its 1024² one (the CLI's --box_canvas)
XL_BOX_CANVAS = 512
# the W8A8 character pass: the quantized IP UNet at 512 px, its eps within
# this bound of the float IP UNet of the same seed (relative to max|ref|)
CHAR_W8A8, W8A8_FLOAT_BOUND = "sd15_512_ip_w8a8", 3e-2
# batch-1 evaluations (no CFG: the CFG cutoff's tail, every LCM step) of
# SD1.5 at 512 px and SDXL at 1024 px
SD15_B1, SDXL_B1 = "sd15_512_cond", "sdxl_1024_cond"
# (model, shape, calls per UNet evaluation of that model); batch 1 with
# CFG, so 2 rows.  SD1.5: 10 transformer blocks at 64²/32²/16²/8²;
# SDXL: 10 blocks at 64² (4 down, 6 up) and 60 at 32² (20 down, 10 mid,
# 30 up), head dim 64 throughout, FF split (geglu_matmul)
FLASH_SHAPES = [(SD15, (2, 4096, 8, 40), 5), (SD15, (2, 1024, 8, 80), 5),
                (SDXL, (2, 4096, 10, 64), 10), (SDXL, (2, 1024, 20, 64), 60),
                (SD15_1024, (2, 1024, 8, 160), 5),
                (SD15_B1, (1, 4096, 8, 40), 5), (SD15_B1, (1, 1024, 8, 80), 5)]
# the long route (past 4096 tokens): SD1.5 at 768 px, level 0 (96²), 5 calls
# in the IP UNet and 2 in the ControlNet per final-pass evaluation
FLASH_LONG_SHAPES = [(FINAL_768, (2, 9216, 8, 40), 7)]
# the BSHD-native route (row 3, THEATERGEN_FLASH_BSHD=1) and the copy-based
# one (row 4: THEATERGEN_FLASH_FLAT=0 for a W8A8 UNet, FLAT16K=0 at 768 px)
# at the sites they take; row 4 also at sequence parallelism's per-shard
# shapes, Sq/n queries against all 9216 keys (n = 2, 4), as
# (B, Sq, Sk, H, D), 7 calls per evaluation on each rank
FLASH_BSHD_SHAPES = [(W8A8, (2, 4096, 8, 40), 5), (W8A8, (2, 1024, 8, 80), 5),
                     (FINAL_768, (2, 9216, 8, 40), 7)]
FLASH_COPY_SHAPES = FLASH_BSHD_SHAPES + [
    (SP2_768, (2, 4608, 9216, 8, 40), 7), (SP4_768, (2, 2304, 9216, 8, 40), 7)]
# ff_matmul's (M, D, K): SD1.5 at 512 px (the UNet's 16 blocks), and the
# 768-px final pass (IP UNet 5 + ControlNet 2 per level; the mid block's
# 288 rows take no kernel)
FF_SHAPES = [(SD15, (8192, 320, 1280), 5), (SD15, (2048, 640, 2560), 5),
             (SD15, (512, 1280, 5120), 5), (SD15, (128, 1280, 5120), 1),
             (FINAL_768, (18432, 320, 1280), 7),
             (FINAL_768, (4608, 640, 2560), 7),
             (FINAL_768, (1152, 1280, 5120), 7),
             (SD15_B1, (4096, 320, 1280), 5), (SD15_B1, (1024, 640, 2560), 5),
             (SD15_B1, (256, 1280, 5120), 5)]
# batch 1 (SD1.5 cond-only): the mid block's 64 rows take neither FF
# kernel (no row block of 128 or more divides 64), as in the JAX package
GEGLU_SHAPES = [(SDXL, (8192, 2560, 640), 10), (SDXL, (2048, 5120, 1280), 60),
                (SDXL_B1, (4096, 2560, 640), 10),
                (SDXL_B1, (1024, 5120, 1280), 60)]
# quant_matmul's (M, K, N) in one W8A8 SD1.5 UNet evaluation (CFG batch 2)
# and calls per evaluation (184): per transformer block the six (M, C, C)
# projections, to_k/to_v of the 77-token context (M = 154, K = 768),
# ff.net.0.proj (N = 8C) and ff.net.2 (K = 4C), at 64², 32², 16² (5 blocks
# each) and 8² (the mid block); 22 time_emb_proj and 2 time_embedding
# linears at M = 2.  Then a ragged shape the path does not run (calls 0)
QMM_SHAPES = [(W8A8, mkn, n) for mkn, n in (
    ((8192, 320, 320), 30), ((154, 768, 320), 10), ((8192, 320, 2560), 5),
    ((8192, 1280, 320), 5), ((2048, 640, 640), 30), ((154, 768, 640), 10),
    ((2048, 640, 5120), 5), ((2048, 2560, 640), 5), ((512, 1280, 1280), 30),
    ((154, 768, 1280), 12), ((512, 1280, 10240), 5), ((512, 5120, 1280), 5),
    ((128, 1280, 1280), 6), ((128, 1280, 10240), 1), ((128, 5120, 1280), 1),
    ((2, 320, 1280), 1), ((2, 1280, 1280), 13), ((2, 1280, 640), 5),
    ((2, 1280, 320), 5), ((40, 128, 130), 0))]
QMM_PER_EVAL = 184
# GroupNorm sites that reach the kernel under THEATERGEN_FUSED_GN=1, CFG
# batch 2, 32 groups: (B, C, H·W) and calls per evaluation.  The SD1.5
# UNet (the IP UNet's are the same) at 512 px: 61, 45 with SiLU.  SDXL at
# 1024 px: 42 of its 46; 128²×640, 128²×960 and 64²×1920 fail the TPU
# gate's size limit and stay on F.group_norm.  The 768-px final pass: the
# IP UNet's 58 (96²×640 and 96²×960 fail the size limit) and the
# ControlNet's 27
GN_SD15_SITES = (
    ((320, 4096), 13), ((640, 4096), 2), ((960, 4096), 1),
    ((320, 1024), 1), ((640, 1024), 11), ((960, 1024), 1), ((1280, 1024), 1),
    ((1920, 1024), 1), ((640, 256), 1), ((1280, 256), 11), ((1920, 256), 1),
    ((2560, 256), 2), ((1280, 64), 12), ((2560, 64), 3))
GN_SHAPES = [(CHAR, (2, c, hw), n) for (c, hw), n in GN_SD15_SITES] + [
    (SD15_B1, (1, c, hw), n) for (c, hw), n in GN_SD15_SITES] + [
    (SDXL, (2, c, hw), n) for (c, hw), n in (
        ((320, 16384), 8), ((320, 4096), 1), ((640, 4096), 11),
        ((960, 4096), 1), ((1280, 4096), 1), ((640, 1024), 1),
        ((1280, 1024), 16), ((1920, 1024), 1), ((2560, 1024), 2))] + [
    (FINAL_768, (2, c, hw), n) for (c, hw), n in (
        ((320, 9216), 19), ((320, 2304), 2), ((640, 2304), 16),
        ((960, 2304), 1), ((1280, 2304), 1), ((1920, 2304), 1),
        ((640, 576), 2), ((1280, 576), 16), ((1920, 576), 1),
        ((2560, 576), 2), ((1280, 144), 21), ((2560, 144), 3))]
# GroupNorm kernel launches per UNet evaluation under THEATERGEN_FUSED_GN=1
# (the final pass: IP UNet + ControlNet; at 768 px the UNet's three norms
# at 96²×640 and 96²×960 fail the TPU gate's size limit)
GN_PER_EVAL = {SD15: 61, SDXL: 42, CHAR: 61, FINAL: 61 + 27,
               CHAR_768: 58, FINAL_768: 58 + 27}
# flash (by route) and ff_geglu launches per evaluation of the back half's
# paths (tests/test_torch_port_final.py::FINAL_SITES counts them on the
# meta device): at 768 px level 1 (2304 tokens) takes no flash kernel and
# the mid block's FF (288 rows) neither FF kernel, as in the JAX package
PER_EVAL = {CHAR: dict(flash_attention=10, ff_geglu=16),
            FINAL: dict(flash_attention=10 + 4, ff_geglu=16 + 7),
            CHAR_768: dict(flash_attention_long=5, ff_geglu=15),
            FINAL_768: dict(flash_attention_long=5 + 2, ff_geglu=15 + 6)}
# the large-mean GroupNorm input: mean 1024, std 1.5 before the rounding to
# bf16 (whose step there is 4 to 8), so mean/std ~ 700 and E[x²] - mean²
# in fp32 would lose the variance (tests/test_torch_port_cuda.py shows
# such a variant failing the bound that the kernel meets)
GN_LARGE_MEAN, GN_LARGE_STD = 1024.0, 1.5
SD15_STEPS, SDXL_STEPS = 50, 30
# the knob requests: Text2Img with DeepCache every 3rd step (50 DDIM
# steps), and LCM at 4 steps (SD1.5 after a synthetic LCM-LoRA merge of
# rank LORA_RANK, and SDXL)
DEEPCACHE_INTERVAL, LCM_STEPS, LORA_RANK = 3, 4, 64
# the CLI's knob runs over dialogue_0: (label, flags, steps, the step plan's
# knobs); the 4-step LCM run also writes the --profile trace (checked, then
# deleted), the shortest run to trace, so the guided dialogue has room
TURN_KNOBS = (
    ("a", ["--deepcache", "3", "--cfg_cutoff", "0.5", "--cn_interval", "2"],
     50, dict(deepcache=3, cutoff=0.5, cn_interval=2)),
    ("b", ["--scheduler", "lcm", "--profile"], 4, dict(sampler="lcm")),
    ("c", ["--scheduler", "euler_ancestral", "--prediction_type",
           "v_prediction", "--zero_snr"], 30,
     dict(sampler="euler_ancestral")))
# the flash switches that send attention down rows 3 and 4: (environment
# setting, module attributes, counter).  In the W8A8 UNet (no packed
# projections) BSHD takes every flash site and FLAT=0 sends them to the
# copy-based kernel; at 768 px BSHD takes level 0 (9216 tokens) and so does
# the copy-based kernel with FLAT16K=0; the packed sites at 512 px stay
SWITCH_REQUESTS = (
    ("THEATERGEN_FLASH_BSHD=1", dict(BSHD_NATIVE=True),
     "flash_attention_bshd"),
    ("THEATERGEN_FLASH_FLAT=0", dict(FLAT=False), "flash_attention_copy"))
SWITCH_REQUESTS_768 = (
    ("THEATERGEN_FLASH_BSHD=1", dict(BSHD_NATIVE=True),
     "flash_attention_bshd"),
    ("THEATERGEN_FLASH_FLAT16K=0", dict(FLAT_ONLINE=False),
     "flash_attention_copy"))
# the character requests' (THEATERGEN_FUSED_GN, ip_scale)
CHAR_REQUESTS = (("1", 0.4), ("1", 0.0), ("0", 0.4))
# the back half's characters: (ip_scale, layout box) at 512 px and 768 px;
# the final pass's frozen steps and IP scale (frozen_step_ratio 0.5,
# ip_scale_final 0.1).  Random weights give near-uniform reference maps,
# so a character's mask covers the canvas; each box's centre lies about a
# quarter of the canvas off the middle, so alignment shifts the mask and
# the frozen mask leaves a free region for the blend's other side
FINAL_CHARS = {512: ((0.4, (0.05, 0.2, 0.45, 0.95)),
                     (0.0, (0.55, 0.35, 0.95, 0.9))),
               768: ((0.4, (0.05, 0.15, 0.5, 0.95)),)}
FROZEN_STEPS, IP_SCALE_FINAL = 25, 0.1
OVERALL_PROMPT = "a red knight and a girl with a blue umbrella in a forest"
# dialogue_0's characters per turn, as DB hits: turn 1 draws the knight
# (obj 0) and the dragon (obj 1), turns 2 and 3 find them, turn 4 finds the
# dragon and draws a second one (obj 2)
TURN_HITS = [[False, False], [True], [True], [True, False]]
# --profile: request pairs of the GroupNorm A/B ("0" and "1" in turns,
# ABBA order) for the character pass and SDXL
AB_PAIRS = {CHAR: 12, SDXL: 8}
PROMPTS = ["a red knight rides through a dark forest",
           "a girl with a blue umbrella on a rainy street",
           "two cats asleep on a wooden table"]
# latent guidance (--guidance): the kernels' gradient gates at the guided
# UNets' batch-1 shapes, (kernel record, model, shape); flash (B, S, H, D),
# ff_geglu (M, D, K), geglu_matmul (M, K, N), group_norm (B, C, HW, act)
GRAD_SHAPES = (
    [("flash_attention", SD15_B1, (1, 4096, 8, 40)),
     ("flash_attention", SD15_B1, (1, 1024, 8, 80)),
     ("flash_attention", SDXL_B1, (1, 4096, 10, 64)),
     ("flash_attention", SDXL_B1, (1, 1024, 20, 64)),
     ("ff_geglu", SD15_B1, (4096, 320, 1280)),
     ("ff_geglu", SD15_B1, (1024, 640, 2560)),
     ("ff_geglu", SD15_B1, (256, 1280, 5120)),
     ("geglu_matmul", SDXL_B1, (4096, 2560, 640)),
     ("geglu_matmul", SDXL_B1, (1024, 5120, 1280))]
    + [("group_norm", SD15_B1, (1, c, hw, "silu")) for (c, hw), _ in
       GN_SD15_SITES] + [("group_norm", SD15_B1, (1, 1280, 256, None))])
# the energy's latent gradient through the full SD1.5 IP UNet (beside
# unet_reference_phase's 5e-2 on the eps).  Kernels against plain_path():
# bounds on max|diff|/max|ref| and on the cosine.  The energy is a top-k
# mean, so a rounding that moves an attention entry across the k-th
# largest sends its gradient elsewhere: on an H100 80GB HBM3 at 700 W the
# bf16 plain path's own gradient is 0.159-0.187 (max) and 0.083-0.120
# (L2) from an fp32 UNet's over three inputs, and the max bound is set
# above that noise.  Against the fp32 UNet: the kernels' L2 distance
# within ENERGY_FP32_RATIO of the bf16 plain path's, and the cosine at
# least ENERGY_FP32_COS (with flash's branch detached: 0.212 against
# 0.122, cosine 0.977; the FF's: 0.736, 0.677;
# scripts/torch_guidance_grad.py)
ENERGY_GRAD_BOUND, ENERGY_COS_BOUND = 0.5, 0.98
ENERGY_FP32_RATIO, ENERGY_FP32_COS = 1.75, 0.985
# the guided dialogue and the guided SDXL character request (10
# Euler-Ancestral steps at 1024 px, every one guided: guidance_steps 25)
GUIDED_TURN, XL_GUIDED, XL_GUIDED_STEPS = "sd15_512_turn_guided", \
    "sdxl_1024_ip_guided", 10
# kernel -> (module, its launch counter)
COUNTERS = {"flash_attention": (fa, "launches"),
            "flash_attention_long": (fa, "launches_long"),
            "flash_attention_bshd": (fa, "launches_bshd"),
            "flash_attention_copy": (fa, "launches_copy"),
            "ff_geglu": (gg, "ff_launches"),
            "geglu_matmul": (gg, "geglu_launches"),
            "group_norm": (gn, "launches"),
            "quant_matmul": (qm, "launches")}


def log(*a):
    print(*a, flush=True)


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def counts(**kw) -> dict:
    """Launches per request of every counted kernel: 0 unless given."""
    return {name: kw.get(name, 0) for name in COUNTERS}


def add_launches(records, model: str, got: dict) -> None:
    for r in records:
        r["launches"] += got[r["name"]]
        if model in r["per_model"]:
            r["per_model"][model]["launches"] += got[r["name"]]


def bound(flops: float, nbytes: float, peak_ops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_ops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed and timed with CUDA events, so the host's launch cost (which
    exceeds a small kernel's run) drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    return time_ms(graph.replay, 5, 1) / iters


def cold_graph_ms(fn, inputs) -> float:
    """Device time of one call that reads its input from device memory:
    one call per input, in turn, captured in a CUDA graph, the inputs
    together over twice the 50 MB L2 (``cold_inputs``), so that each is
    evicted before its next call; replayed and timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(inputs[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for x in inputs:
            fn(x)
    graph.replay()
    return time_ms(graph.replay, 3, 1) / len(inputs)


def cold_inputs(make, nbytes: int, total: float = COLD_BYTES) -> list:
    """Distinct inputs from ``make()``, at least 4 and together over
    ``total`` bytes."""
    return [make() for _ in range(max(4, -(-int(total) // nbytes)))]


def randn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, device="cuda", generator=gen) * scale).to(
        torch.bfloat16)


def check(err: float, ref_max: float, what: str) -> None:
    ok = err <= TOL * ref_max
    log(f"  {what}: max_abs_err {err:.3e}  bound {TOL * ref_max:.3e} "
        f"(1e-2*max|ref|)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{what}: kernel disagrees with its plain version")


def _row(model, shape, calls, err, flops, nbytes, kernel, plain, library,
         plain_iters, graphs=False, peak_ops=PEAK_BF16_FLOPS):
    """Times by CUDA events over back-to-back eager calls; with ``graphs``
    by CUDA-graph replay (device time, graph_ms), the eager kernel time
    kept as ``eager_ms``."""
    bms, by = bound(flops, nbytes, peak_ops)
    row = dict(model=model, shape=list(shape), calls_per_unet_eval=calls,
               max_abs_err=err, bound_ms=bms, bound_by=by)
    if graphs:
        row.update(ms=graph_ms(kernel), plain_ms=graph_ms(plain, plain_iters),
                   library_ms=graph_ms(library),
                   eager_ms=time_ms(kernel, 20), timed="cuda_graph")
    else:
        row.update(ms=time_ms(kernel, 20),
                   plain_ms=time_ms(plain, plain_iters, 1),
                   library_ms=time_ms(library, 20), timed="eager")
    log(f"  {model} {list(shape)} x{calls}: kernel {row['ms']:.5f} ms  plain "
        f"{row['plain_ms']:.5f}  library {row['library_ms']:.5f}  bound "
        f"{bms:.5f} ({by})"
        + (f"  eager kernel {row['eager_ms']:.5f}" if graphs else ""))
    return row


@contextlib.contextmanager
def flash_switches(**attrs):
    """Set the flash module's switches (the JAX package's
    THEATERGEN_FLASH_* variables, mirrored as module attributes) for the
    block, and restore them."""
    saved = {name: getattr(fa, name) for name in attrs}
    for name, value in attrs.items():
        setattr(fa, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(fa, name, value)


def flash_phase(gen, shapes, route: str) -> list:
    """The flash kernel on one route's counter at each shape ((B, S, H, D)
    self-attention or (B, Sq, Sk, H, D)): checked against its plain
    version, timed beside the plain version and SDPA."""
    rows = []
    for model, shape, calls in shapes:
        b, sq, h, d = (shape[0], shape[1], shape[-2], shape[-1])
        sk = shape[2] if len(shape) == 5 else sq
        q = randn(gen, b, sq, h, d)
        k, v = (randn(gen, b, sk, h, d) for _ in range(2))
        plan = fa.launch_plan(b, sq, h, d)
        log(f"  flash {route} {model} Sq={sq} Sk={sk} H={h} d={d}: launch "
            f"plan {json.dumps(plan)}")
        out = fa.flash_attention(q, k, v, route=route)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        check(err, ref.abs().max().item(),
              f"flash {route} {model} Sq={sq} Sk={sk} H={h} d={d}")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        rows.append(_row(
            model, shape, calls, err, fa.flops(b, sq, h, d, sk),
            fa.min_bytes(b, sq, h, d, sk),
            lambda: fa.flash_attention(q, k, v, route=route),
            lambda: fa.flash_attention_plain(q.float(), k.float(), v.float()),
            lambda: F.scaled_dot_product_attention(qt, kt, vt), 3))
        rows[-1]["plan"] = plan
        del q, k, v, qt, kt, vt, ref, out
        torch.cuda.empty_cache()
    return rows


def sp_shards_phase(gen) -> dict:
    """Sequence parallelism's per-shard body on one card: the 768-px level
    0 (B2 S9216 H8 d40) split into n = 2 and 4 query shards, each run
    against all the keys on row 4's route; the concatenated shards must
    equal the unsharded call bit for bit (each 128-row q block sees the
    same inputs either way: fa.Q_BLOCK divides both shard lengths)."""
    q, k, v = (randn(gen, 2, 9216, 8, 40) for _ in range(3))
    full = fa.flash_attention(q, k, v, route="copy")
    out = {}
    for n in (2, 4):
        s = 9216 // n
        parts = [fa.flash_attention(q[:, i * s:(i + 1) * s], k, v,
                                    route="copy") for i in range(n)]
        joined = torch.cat(parts, dim=1)
        torch.cuda.synchronize()
        out[n] = bool(torch.equal(joined, full))
        log(f"  sequence-parallel shards n={n} (Sq {s} against Sk 9216): "
            f"concatenated == unsharded {out[n]}  "
            f"{'ok' if out[n] else 'FAIL'}")
        if not out[n]:
            raise SystemExit(f"flash: {n} query shards disagree with the "
                             f"unsharded call")
    return out


def ff_phase(gen) -> dict:
    rows = []
    for model, (m, d, k), calls in FF_SHAPES:
        x = randn(gen, m, d)
        w1 = randn(gen, 2 * k, d, scale=d ** -0.5)
        b1 = randn(gen, 2 * k, scale=0.1)
        w2 = randn(gen, d, k, scale=k ** -0.5)
        slots = gg._ff_slots(x.device, d)
        c, bm, splits = gg.ff_plan(m, d, k, slots)
        plan = dict(cluster=c, bm=bm, splits=splits, stages=gg.FF_STAGES,
                    chunk=gg.ff_chunk(d), ctas=-(-m // bm) * c * splits,
                    cta_slots=slots)
        log(f"  ff {model} M={m} D={d} K={k}: launch plan {json.dumps(plan)}")
        out = gg.ff_matmul(x, w1, b1, w2)
        torch.cuda.synchronize()
        ref = gg.ff_matmul_plain(x.float(), w1.float(), b1.float(),
                                 w2.float())
        err = (out.float() - ref).abs().max().item()
        check(err, ref.abs().max().item(), f"ff {model} M={m} D={d} K={k}")

        def library():
            val, gate = F.linear(x, w1, b1).chunk(2, dim=-1)
            return torch.matmul(val * F.gelu(gate), w2.t())

        rows.append(_row(
            model, (m, d, k), calls, err, gg.ff_flops(m, d, k),
            gg.ff_min_bytes(m, d, k), lambda: gg.ff_matmul(x, w1, b1, w2),
            lambda: gg.ff_matmul_plain(x.float(), w1.float(), b1.float(),
                                       w2.float()), library, 5))
        rows[-1]["plan"] = plan
    return _record("ff_geglu", "csrc/ff_geglu.cu",
                   "theatergen_tpu/ops/geglu_matmul.py:471",
                   "ff_matmul (_ff_matmul_2d)", rows)


def host_us_phase(gen) -> dict:
    """Host µs per call of the wrappers: flash and FF at one SD1.5 512-px
    shape each (level 0: B2 S4096 H8 d40, M8192 D320 K1280),
    geglu_matmul at SDXL's M2048 K5120 N1280, quant_matmul at the W8A8
    UNet's most frequent shape (M8192 K320 N320) and an M = 2 one (M2
    K1280 N1280, split K), and group_norm at SD1.5's 8²×1280 (the plan
    memoised): 200 calls enqueued back to back, timed on the
    host clock before the synchronise (the device runs behind, so this is
    the wrapper's own cost: checks, the planner, tensor maps, workspace
    and the ctypes launch)."""
    q, k, v = (randn(gen, 2, 4096, 8, 40) for _ in range(3))
    x = randn(gen, 8192, 320)
    w1, b1 = randn(gen, 2560, 320, scale=320 ** -0.5), randn(gen, 2560)
    w2 = randn(gen, 320, 1280, scale=1280 ** -0.5)
    hg, wg = randn(gen, 2048, 10240), randn(gen, 1280, 5120, scale=0.014)
    qargs = {}
    for m, kk, n in ((8192, 320, 320), (2, 1280, 1280)):
        wq, ws = qz.quantize_linear_weight(
            torch.randn(n, kk, device="cuda", generator=gen) * kk ** -0.5)
        qargs[(m, kk, n)] = (randn(gen, m, kk), wq, ws,
                             randn(gen, n, scale=0.1))
    xg = randn(gen, 2, 1280, 8, 8)
    wg1, bg1 = randn(gen, 1280, scale=0.2) + 1, randn(gen, 1280, scale=0.1)
    out = {}
    for name, fn in (("flash_attention B2 S4096 H8 d40",
                      lambda: fa.flash_attention(q, k, v, route="packed")),
                     ("ff_geglu M8192 D320 K1280",
                      lambda: gg.ff_matmul(x, w1, b1, w2)),
                     ("geglu_matmul M2048 K5120 N1280",
                      lambda: gg.geglu_matmul(hg, wg)),
                     ("quant_matmul M8192 K320 N320",
                      lambda: qm.quant_matmul(*qargs[(8192, 320, 320)])),
                     ("quant_matmul M2 K1280 N1280",
                      lambda: qm.quant_matmul(*qargs[(2, 1280, 1280)])),
                     ("group_norm B2 C1280 HW64",
                      lambda: gn.fused_group_norm(xg, wg1, bg1,
                                                  act="silu"))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        out[name] = us
        log(f"  host time of the wrapper, {name}: {us:.2f} µs per call")
    return out


def geglu_phase(gen) -> dict:
    rows = []
    for model, (m, k, n), calls in GEGLU_SHAPES:
        hg = randn(gen, m, 2 * k)
        w = randn(gen, n, k, scale=k ** -0.5)
        slots = gg._geglu_slots(hg.device, n)
        c, bm, splits = gg.geglu_plan(m, n, k, slots)
        plan = dict(cluster=c, bm=bm, splits=splits, stages=gg.GEGLU_STAGES,
                    chunk=gg.geglu_chunk(n), ctas=-(-m // bm) * c * splits,
                    cta_slots=slots)
        log(f"  geglu_matmul {model} M={m} K={k} N={n}: launch plan "
            f"{json.dumps(plan)}")
        out = gg.geglu_matmul(hg, w)
        torch.cuda.synchronize()
        ref = gg.geglu_matmul_plain(hg.float(), w.float())
        err = (out.float() - ref).abs().max().item()
        check(err, ref.abs().max().item(),
              f"geglu_matmul {model} M={m} K={k} N={n}")
        val, gate = hg[:, :k], hg[:, k:]
        rows.append(_row(
            model, (m, k, n), calls, err, gg.geglu_flops(m, k, n),
            gg.geglu_min_bytes(m, k, n), lambda: gg.geglu_matmul(hg, w),
            lambda: gg.geglu_matmul_plain(hg.float(), w.float()),
            lambda: torch.matmul(val * F.gelu(gate), w.t()), 5))
        rows[-1]["plan"] = plan
        del hg, w, out, ref, val, gate
    return _record("geglu_matmul", "csrc/geglu_matmul.cu",
                   "theatergen_tpu/ops/geglu_matmul.py:222",
                   "geglu_matmul (_geglu_matmul_2d)", rows)


def gn_phase(gen) -> dict:
    """fused_group_norm at every site shape of both UNets: its launch plan
    printed, checked with and without SiLU and with a large-mean input
    (GN_LARGE_MEAN), timed with SiLU against the library pair
    F.group_norm + F.silu in bf16, as CUDA-graph replays (the eager launch
    outlasts these kernels): warm (``ms``, 20 calls on one input, which
    stays in L2) and cold (``cold_ms``, a rotation of inputs over 100 MB,
    ``cold_graph_ms``)."""
    rows = []
    for model, (b, c, hw), calls in GN_SHAPES:
        side = int(hw ** 0.5)
        plan = gn.launch_plan(b, c, hw, 32)._asdict()
        plan["ctas"] = b * 32 * plan["cluster"]
        log(f"  group_norm {model} B={b} C={c} HW={hw}: launch plan "
            f"{json.dumps(plan)}")
        w = (1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)).to(
            torch.bfloat16)
        bias = randn(gen, c, scale=0.1)
        err = 0.0
        for act, mean, std in ((None, 0.0, 1.0), ("silu", 0.0, 1.0),
                               ("silu", GN_LARGE_MEAN, GN_LARGE_STD)):
            x = randn(gen, b, c, side, side, scale=std) + mean
            out = gn.fused_group_norm(x, w, bias, act=act)
            torch.cuda.synchronize()
            ref = gn.fused_group_norm_plain(x.float(), w.float(),
                                            bias.float(), act=act)
            e = (out.float() - ref).abs().max().item()
            check(e, ref.abs().max().item(),
                  f"group_norm C={c} HW={hw} act={act} mean={mean:g}")
            err = max(err, e)
        x = randn(gen, b, c, side, side)
        rows.append(_row(
            model, (b, c, hw), calls, err, 0.0, gn.min_bytes(b, c, hw),
            lambda: gn.fused_group_norm(x, w, bias, act="silu"),
            lambda: gn.fused_group_norm_plain(x, w, bias, act="silu"),
            lambda: F.silu(F.group_norm(x, 32, w, bias, 1e-5)), 5,
            graphs=True))
        xs = cold_inputs(lambda: randn(gen, b, c, side, side),
                         x.numel() * 2)
        rows[-1].update(
            plan=plan,
            cold_ms=cold_graph_ms(
                lambda xi: gn.fused_group_norm(xi, w, bias, act="silu"), xs),
            library_cold_ms=cold_graph_ms(
                lambda xi: F.silu(F.group_norm(xi, 32, w, bias, 1e-5)), xs))
        log(f"    cold (a rotation of {len(xs)} inputs): kernel "
            f"{rows[-1]['cold_ms']:.5f} ms  library "
            f"{rows[-1]['library_cold_ms']:.5f}")
        del xs
    rec = _record("group_norm", "csrc/group_norm.cu",
                  "theatergen_tpu/ops/groupnorm.py:140",
                  "fused_group_norm (_gn_fused)", rows)
    for model, pm in rec["per_model"].items():
        log(f"  group_norm per {model} evaluation: warm {pm['ms']:.5f} ms  "
            f"cold {pm['cold_ms']:.5f}  bound {pm['bound_ms']:.5f}  library "
            f"warm {pm['library_ms']:.5f} cold {pm['library_cold_ms']:.5f}")
    return rec


def qmm_phase(gen) -> dict:
    """quant_matmul at every shape of the W8A8 UNet and a ragged one,
    with a bias (every call of the path but to_q/to_k/to_v has one):
    checked against the plain version from the same bf16 inputs: the two
    are built to agree bit for bit, so one differing output fails (the
    1e-2·max|ref| bound of the other kernels is far wider than the error
    of a kernel that skipped the per-row quantization); timed as
    CUDA-graph replays (the M = 2 calls are shorter than an eager launch)
    against the library layer W8A8 replaces, ``F.linear`` in bf16 with the
    dequantized weight.  The bound takes the int8 peak."""
    rows = []
    for model, (m, k, n), calls in QMM_SHAPES:
        x = randn(gen, m, k)
        w = torch.randn(n, k, device="cuda", generator=gen) * k ** -0.5
        wq, ws = qz.quantize_linear_weight(w)
        bias = randn(gen, n, scale=0.1)
        w_deq = (wq.float() * ws[:, None]).to(torch.bfloat16)
        c, bm, bn, splits = qm.launch_plan(x.device, m, n, k)
        rb, nt, steps = qm.qmm_tiles(m, n, k)
        plan = dict(cluster=c, bm=bm, bn=bn, splits=splits,
                    k_steps=steps, ctas=rb * nt * splits,
                    cta_slots=qm.qmm_slots(x.device, c),
                    a_quantised_times=nt // c)
        log(f"  quant_matmul M={m} K={k} N={n}: launch plan "
            f"{json.dumps(plan)}")
        out = qm.quant_matmul(x, wq, ws, bias)
        torch.cuda.synchronize()
        ref = qm.quant_matmul_plain(x, wq, ws, bias)
        err = (out.float() - ref.float()).abs().max().item()
        differ = int((out != ref).sum())
        check(err, ref.float().abs().max().item(),
              f"quant_matmul M={m} K={k} N={n} "
              f"({differ} of {m * n} outputs differ)")
        if differ:
            raise SystemExit(f"quant_matmul M={m} K={k} N={n}: {differ} "
                             f"outputs differ from the plain version")
        rows.append(_row(
            model, (m, k, n), calls, err, qm.flops(m, k, n),
            qm.min_bytes(m, k, n), lambda: qm.quant_matmul(x, wq, ws, bias),
            lambda: qm.quant_matmul_plain(x, wq, ws, bias),
            lambda: F.linear(x, w_deq, bias), 5, graphs=True,
            peak_ops=PEAK_INT8_OPS))
        rows[-1]["plan"] = plan
        del x, w, wq, ws, bias, w_deq, out, ref
    return _record("quant_matmul", "csrc/quant_matmul.cu",
                   "theatergen_tpu/ops/quant_matmul.py:92",
                   "quant_matmul (_qmm_kernel)", rows)


def _record(name, source, replaces, tpu_function, rows) -> dict:
    """One kernel's record.  Times are summed over one UNet evaluation of
    each model that calls the kernel (each shape times its calls; for the
    final pass one IP UNet and one ControlNet evaluation), and per model
    under ``per_model``; ``launches`` are added by the main paths."""
    keys = [k for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "eager_ms", "cold_ms", "library_cold_ms")
            if k in rows[0]]
    per_model = {}
    for r in rows:
        pm = per_model.setdefault(r["model"], dict.fromkeys(keys, 0.0))
        for key in keys:
            pm[key] += r[key] * r["calls_per_unet_eval"]
        pm["launches"] = 0
    total = {key: sum(pm[key] for pm in per_model.values()) for key in keys}
    return dict(
        name=name, route="cuda", source=f"theatergen_tpu_torch/{source}",
        replaces=replaces, tpu_function=tpu_function, launches=0,
        max_abs_err=max(r["max_abs_err"] for r in rows), **total,
        bound_by=max(rows, key=lambda r: r["bound_ms"])["bound_by"],
        per="one UNet evaluation of each model that calls it (sd15_512: "
            "SD1.5 512 px, sdxl_1024: SDXL 1024 px, sd15_512_ip: the SD1.5 "
            "IP UNet of the character pass, sd15_512_w8a8: the SD1.5 W8A8 "
            "UNet, sd15_768_final: the IP UNet and the ControlNet of the "
            "768-px final pass, sd15_1024: SD1.5 1024 px, sd15_768_sp2/4: "
            "one rank's share of the 768-px final pass over 2/4 "
            "sequence-parallel ranks), batch 1 with CFG; sd15_512_cond and "
            "sdxl_1024_cond: one batch-1 evaluation without CFG (the CFG "
            "cutoff's tail, every LCM step), whose launches are the LCM "
            "requests'",
        per_model=per_model, shapes=rows)


def gn_want(model: str, steps: int) -> int:
    """GroupNorm kernel launches of one request under the current switch."""
    return GN_PER_EVAL[model] * steps if gn.FUSED_MODE == "1" else 0


# flash's route counters by the wrapper's attribute
FLASH_COUNTERS = {attr: name for name, (mod, attr) in COUNTERS.items()
                  if mod is fa}


def eval_launches(ucfg, side: int, batch: int, shallow: bool = False,
                  encoder_only: bool = False, cache_level: int = 1):
    """Kernel launches of one evaluation of a UNet (``encoder_only``: a
    ControlNet, its encoder and mid block) of config ``ucfg`` on a
    ``side``² latent at ``batch`` rows, derived from the layers' routing
    functions at each site's shape (``fa.route`` for self-attention,
    ``gg.ff_supported`` then ``gg.supported`` for the FF,
    ``gn.routes`` under the current switch for a bf16 GroupNorm), walking
    the modules in forward order.  ``shallow``: DeepCache's shallow
    forward, the first ``cache_level`` levels of the encoder (without
    their last downsampler) and the last ``cache_level`` up blocks.  A
    quantized UNet's ``quant_matmul`` launches, under
    ``THEATERGEN_FUSED_INT8`` "1", are its ``QuantLinear`` calls: the time
    embedding's two, each resnet's ``time_emb_proj``, and per transformer
    layer the two attentions' q, k, v and out projections, the FF's two
    linears and, with IP tokens, ``to_k_ip``/``to_v_ip``."""
    got = collections.Counter()
    boc, n, lpb = ucfg.block_out_channels, len(ucfg.block_out_channels), \
        ucfg.layers_per_block
    qmm = ucfg.quantized and qz.FUSED_MODE == "1"

    def linears(k):
        if qmm:
            got["quant_matmul"] += k

    def norm(c, level):
        s = side >> level
        if ucfg.fast_norm and gn.routes((batch, c, s, s), torch.bfloat16,
                                        ucfg.norm_num_groups):
            got["group_norm"] += 1

    def resnet(cin, cout, level):
        norm(cin, level)
        norm(cout, level)
        linears(1)

    def transformer(level, ch):
        norm(ch, level)
        heads, hw = ucfg.heads_at(level), (side >> level) ** 2
        for _ in range(ucfg.depth_at(level)):
            route = fa.route(hw, hw, heads, ch // heads, 2, ucfg.quantized) \
                if ucfg.flash_attention else None
            if route is not None:
                got[FLASH_COUNTERS[fa.COUNTERS[route]]] += 1
            m, k = batch * hw, 4 * ch
            if ucfg.quantized:
                linears(8 + 2 + (2 if ucfg.ip_num_tokens else 0))
                continue
            if ucfg.fused_ff and gg.ff_supported(m, ch, k):
                got["ff_geglu"] += 1
            elif gg.supported(m, k, ch):
                got["geglu_matmul"] += 1

    if not encoder_only:
        linears(2)
    levels = cache_level if shallow else n
    skips, h_ch = [boc[0]], boc[0]
    for i in range(levels):
        for _ in range(lpb):
            resnet(h_ch, boc[i], i)
            h_ch = boc[i]
            if ucfg.attention_levels[i]:
                transformer(i, boc[i])
            skips.append(h_ch)
        if i < levels - 1:
            skips.append(h_ch)
    if not shallow:
        resnet(boc[-1], boc[-1], n - 1)
        transformer(n - 1, boc[-1])
        resnet(boc[-1], boc[-1], n - 1)
    if encoder_only:
        return got
    h_ch = boc[min(cache_level, n - 1)] if shallow else boc[-1]
    for idx in range(n - levels if shallow else 0, n):
        i = n - 1 - idx
        for _ in range(lpb + 1):
            resnet(h_ch + skips.pop(), boc[i], i)
            h_ch = boc[i]
            if ucfg.attention_levels[i]:
                transformer(i, boc[i])
    norm(boc[0], 0)
    return got


def step_plan(steps: int, sampler: str = "ddim", cutoff=None,
              deepcache=None, cn_interval=None) -> list:
    """Per step of a runner, ``(cfg, full, controlnet)``: whether it runs
    CFG (batch 2; cond-only after the cutoff, ``ceil(cutoff·steps)`` at
    least 1, and every LCM step), a full UNet forward (step 0 and every
    ``deepcache``-th; shallow in between) and a fresh ControlNet forward
    (every ``cn_interval``-th step)."""
    if sampler == "lcm":
        cut = 0
    elif cutoff is None or cutoff >= 1:
        cut = steps
    else:
        cut = max(1, min(steps, math.ceil(cutoff * steps)))
    dc = deepcache if deepcache and deepcache > 1 else 1
    cn = cn_interval if cn_interval and cn_interval > 1 else 1
    return [(i < cut, i % dc == 0, i % cn == 0) for i in range(steps)]


def request_want(ucfg, side: int, plan, cn_cfg=None) -> dict:
    """Launches of one request: its UNet evaluations by kind (CFG or
    cond-only, full or shallow) and, with ``cn_cfg``, the ControlNet
    forwards of its plan, each kind's launches from eval_launches."""
    kinds = collections.Counter()
    for cfg_on, full, cn in plan:
        b = 2 if cfg_on else 1
        kinds[("unet", b, not full)] += 1
        if cn_cfg is not None and cn:
            kinds[("controlnet", b, False)] += 1
    total = collections.Counter()
    for (what, b, shallow), k in kinds.items():
        per = eval_launches(cn_cfg if what == "controlnet" else ucfg, side, b,
                            shallow, encoder_only=what == "controlnet")
        for name, v in per.items():
            total[name] += k * v
    return counts(**total)


def derivation_check() -> None:
    """eval_launches against the constants the earlier paths are gated
    with (SD1.5, SDXL, the character and final passes at 512 and 768 px,
    full CFG evaluations, switch "1"), and each evaluation kind's
    launches printed; a mismatch fails before any request runs."""
    prev, gn.FUSED_MODE = gn.FUSED_MODE, "1"
    sd, xl = sd15_config(), sdxl_config()
    try:
        want = {
            SD15: (eval_launches(sd.unet, 64, 2),
                   dict(flash_attention=10, ff_geglu=16, group_norm=61)),
            SDXL: (eval_launches(xl.unet, 128, 2),
                   dict(flash_attention=70, geglu_matmul=70, group_norm=42))}
        for model, px in ((CHAR, 64), (CHAR_768, 96)):
            want[model] = (eval_launches(sd.unet, px, 2),
                           dict(PER_EVAL[model], group_norm=GN_PER_EVAL[model]))
        for model, px in ((FINAL, 64), (FINAL_768, 96)):
            got = eval_launches(sd.unet, px, 2) + eval_launches(
                sd.controlnet.unet, px, 2, encoder_only=True)
            want[model] = (got, dict(PER_EVAL[model],
                                     group_norm=GN_PER_EVAL[model]))
        # the XL IP UNet: SDXL's sites (the IP tokens add no kernel site);
        # W8A8 under THEATERGEN_FUSED_INT8=1: the SD1.5 UNet's 184
        # quantized linears, and 16 × 2 more IP projections in the IP UNet
        want[XL_CHAR] = (eval_launches(path_cfg(XL_CHAR)[0], 128, 2),
                         want[SDXL][1])
        prev_q, qz.FUSED_MODE = qz.FUSED_MODE, "1"
        try:
            q = dataclasses.replace(sd.unet, quantized=True)
            w8 = dict(flash_attention=10, group_norm=61)
            want[W8A8] = (eval_launches(q, 64, 2),
                          dict(w8, quant_matmul=QMM_PER_EVAL))
            want[CHAR_W8A8] = (eval_launches(path_cfg(CHAR_W8A8)[0], 64, 2),
                               dict(w8, quant_matmul=QMM_PER_EVAL + 32))
        finally:
            qz.FUSED_MODE = prev_q
        bad = [m for m, (got, ref) in want.items() if counts(**got) != counts(
            **ref)]
        for model, (got, _) in want.items():
            log(f"  derived launches per {model} evaluation: {dict(got)}")
        for name, ucfg, px in (("SD1.5 512 px", sd.unet, 64),
                               ("ControlNet 512 px", sd.controlnet.unet, 64),
                               ("SDXL 1024 px", xl.unet, 128)):
            enc = name.startswith("ControlNet")
            kinds = {f"{'cfg' if b == 2 else 'cond'}"
                     f"{'_shallow' if sh else ''}": dict(eval_launches(
                         ucfg, px, b, sh, encoder_only=enc))
                     for b in (2, 1) for sh in ((False,) if enc
                                                else (False, True))}
            log(f"  {name} evaluation kinds: {json.dumps(kinds)}")
    finally:
        gn.FUSED_MODE = prev
    if bad:
        raise SystemExit(f"derived launches disagree with the constants of "
                         f"{bad}")


def unet_inputs(bundle, seed: int, t_value: int, ctx_len: int = None):
    """A full-size UNet call's inputs (CFG batch 2): sample, timesteps,
    context (``ctx_len`` rows, the text length by default) and, for SDXL,
    pooled text and time ids."""
    cfg = bundle.cfg
    g = torch.Generator(device="cuda").manual_seed(seed)
    h, w = cfg.pipeline.latent_height, cfg.pipeline.latent_width
    x = torch.randn(2, 4, h, w, device="cuda", generator=g)
    ctx = torch.randn(2, ctx_len or cfg.text.max_length,
                      cfg.unet.cross_attention_dim, device="cuda",
                      generator=g)
    t = torch.full((2,), t_value, device="cuda", dtype=torch.long)
    cond = {}
    if cfg.unet.addition_embed_type == "text_time":
        cond = dict(
            pooled_text=torch.randn(2, cfg.text2.projection_dim,
                                    device="cuda", generator=g),
            time_ids=sdxl.default_time_ids(cfg.pipeline.height,
                                           cfg.pipeline.width, 2, "cuda"))
    return x, t, ctx, cond


def unet_reference_phase(bundle, rel_bound: float, unet=None, **kw):
    """One full-size UNet evaluation with the kernels vs plain_path();
    ``unet`` defaults to the bundle's, ``kw`` go to its call.  Returns the
    relative difference and the kernels' eps (fp32)."""
    unet = bundle.unet if unet is None else unet
    x, t, ctx, cond = unet_inputs(bundle, 1, 981,
                                  77 + unet.cfg.ip_num_tokens)
    with torch.no_grad():
        fast = unet(x, t, ctx, **cond, **kw).float()
        with plain_path():
            plain = unet(x, t, ctx, **cond, **kw).float()
    rel = ((fast - plain).abs().max() / plain.abs().max()).item()
    ok = torch.isfinite(fast).all().item() and rel <= rel_bound
    log(f"  UNet eps, kernels vs plain path: max|diff|/max|ref| {rel:.3e} "
        f"(bound {rel_bound:g})  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("UNet with kernels disagrees with its plain path")
    return rel, fast


def run_requests(model, pipe, prompts, want, size, records) -> list:
    """Each request with every counter set to 0 just before it and read
    just after; images and launch counts checked."""
    seconds = []
    for i, prompt in enumerate(prompts):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        reset_counts()
        t0 = time.perf_counter()
        img = pipe(gen, prompt)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        got = read_counts()
        add_launches(records, model, got)
        finite = bool(torch.isfinite(img).all())
        in_range = bool(img.min() >= 0.0 and img.max() <= 1.0)
        log(f"  {model} request {i}: {seconds[-1]:.3f} s  launches {got}  "
            f"shape {tuple(img.shape)}  finite {finite}  range "
            f"[{img.min():.4f}, {img.max():.4f}]  std {img.std():.4f}")
        if tuple(img.shape) != (1, size, size, 3) or not finite \
                or not in_range:
            raise SystemExit(f"{model} request {i}: bad image")
        if got != want:
            raise SystemExit(f"{model} request {i}: launches {got}, "
                             f"want {want}")
    return seconds


def build_bundle(cfg, what: str):
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = init_bundle(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  init_bundle({what}): {time.perf_counter() - t0:.3f} s, UNet "
        f"{sum(p.numel() for p in bundle.unet.parameters()) / 1e6:.1f} M "
        f"params, weights {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    return bundle


def sd15_path(records, profiling: bool) -> dict:
    bundle = build_bundle(sd15_config(), "sd15_config()")
    # bf16 activations through 16 transformer blocks: the two paths round
    # differently (fp32 vs bf16 GEGLU up-projection, fp32 logits)
    rel, eps = unet_reference_phase(bundle, 5e-2)
    pipe = sd.Text2Img(bundle, num_steps=SD15_STEPS)
    want = counts(flash_attention=10 * SD15_STEPS,
                  ff_geglu=16 * SD15_STEPS,
                  group_norm=gn_want(SD15, SD15_STEPS))
    seconds = run_requests(SD15, pipe, PROMPTS, want, 512, records)
    peak = torch.cuda.max_memory_allocated()
    log(f"  seconds per request {seconds}; peak memory "
        f"{peak / 2 ** 30:.3f} GiB")
    knobs = sd15_knob_requests(bundle, records)
    if profiling:
        profile(bundle, sd.encode_prompts)
    return dict(seconds_per_request=seconds, peak_bytes=peak,
                unet_kernels_vs_plain_rel=rel, knob_requests=knobs), eps


def with_pipeline(bundle, **fields):
    """The bundle under a config whose ``pipeline`` fields are replaced
    (the same modules)."""
    cfg = bundle.cfg
    return dataclasses.replace(bundle, cfg=dataclasses.replace(
        cfg, pipeline=dataclasses.replace(cfg.pipeline, **fields)))


def synthetic_lora(unet, rank: int, seed: int) -> dict:
    """A seeded LoRA in peft/diffusers names over every attention
    projection (``attn1``/``attn2`` ``to_q``, ``to_k``, ``to_v``,
    ``to_out.0``) and FF linear (``ff.net.0.proj``, ``ff.net.2``) of the
    UNet: A ~ N(0, 1/in), B ~ N(0, 0.01²/rank)."""
    rng = np.random.RandomState(seed)
    pat = re.compile(r".*\.(attn[12]\.(to_q|to_k|to_v|to_out\.0)|"
                     r"ff\.net\.(0\.proj|2))$")
    sd_ = {}
    for name, mod in unet.named_modules():
        if pat.fullmatch(name):
            out_f, in_f = mod.weight.shape
            sd_[f"unet.{name}.lora_A.weight"] = (
                rng.randn(rank, in_f) / np.sqrt(in_f)).astype(np.float32)
            sd_[f"unet.{name}.lora_B.weight"] = (
                rng.randn(out_f, rank) * 0.01 / np.sqrt(rank)).astype(
                np.float32)
    return sd_


def sd15_knob_requests(bundle, records) -> dict:
    """Text2Img with the knobs on the SD1.5 bundle: one 50-step DDIM
    request with DeepCache every DEEPCACHE_INTERVAL-th step (the config's
    ``deepcache_interval``), and one LCM_STEPS-step LCM request after
    ``apply_lora_unet`` merges a seeded synthetic LoRA (rank LORA_RANK, every
    attention projection and FF linear) into a copy of the UNet; each
    request's launches gated by request_want."""
    t0 = time.perf_counter()
    ucfg = bundle.cfg.unet
    dc = sd.Text2Img(with_pipeline(bundle,
                                   deepcache_interval=DEEPCACHE_INTERVAL),
                     num_steps=SD15_STEPS)
    want = request_want(ucfg, 64, step_plan(SD15_STEPS,
                                             deepcache=DEEPCACHE_INTERVAL))
    log(f"  Text2Img, DeepCache every {DEEPCACHE_INTERVAL}rd step:")
    dc_s = run_requests(SD15 + "_deepcache", dc, PROMPTS[:1], want, 512,
                        records)
    t1 = time.perf_counter()
    lora = synthetic_lora(bundle.unet, LORA_RANK, 11)
    merged = apply_lora_unet(bundle.unet, lora)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t1
    moved = sum(not torch.equal(a, b) for a, b in zip(
        merged.parameters(), bundle.unet.parameters()))
    log(f"  apply_lora_unet: {len(lora) // 2} modules of rank {LORA_RANK} "
        f"merged into a copy in {merge_s:.3f} s; {moved} tensors changed")
    if moved != len(lora) // 2:
        raise SystemExit(f"LoRA merge changed {moved} tensors, want "
                         f"{len(lora) // 2}")
    lcm = sd.Text2Img(dataclasses.replace(bundle, unet=merged),
                      num_steps=LCM_STEPS, sampler="lcm")
    want = request_want(ucfg, 64, step_plan(LCM_STEPS, "lcm"))
    log(f"  Text2Img, LCM {LCM_STEPS} steps on the LoRA-merged UNet:")
    lcm_s = run_requests(SD15_B1, lcm, PROMPTS[:1], want, 512, records)
    del merged, lcm
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(deepcache_seconds=dc_s, lcm_lora_seconds=lcm_s,
               lora_modules=len(lora) // 2, lora_merge_seconds=merge_s,
               phase_seconds=time.perf_counter() - t0)
    log(f"  knob requests phase: {out['phase_seconds']:.1f} s")
    return out


def w8a8_sites_phase(bundle) -> None:
    """One W8A8 UNet evaluation with the kernels, each QuantLinear's output
    held bit for bit to ``quant_matmul_plain`` on the input it met there
    (the kernel is built to match it exactly): a linear that ran in float,
    skipped the per-row quantization or missed the kernel fails here,
    where the whole-UNet check against plain_path() (as wide as the
    quantization error itself) cannot tell."""
    sites, bad = [], []

    def hook(name):
        def check_site(mod, args, out):
            ref = qm.quant_matmul_plain(args[0], mod.weight, mod.scale,
                                        mod.bias)
            sites.append(name)
            if not torch.equal(out, ref):
                bad.append((name, int((out != ref).sum())))
        return check_site

    unet = bundle.unet
    handles = [mod.register_forward_hook(hook(name))
               for name, mod in unet.named_modules()
               if isinstance(mod, QuantLinear)]
    x, t, ctx, _ = unet_inputs(bundle, 2, 501)
    reset_counts()
    try:
        with torch.no_grad():
            unet(x, t, ctx)
    finally:
        for h in handles:
            h.remove()
    launched = read_counts()["quant_matmul"]
    ok = not bad and len(sites) == launched == QMM_PER_EVAL
    log(f"  W8A8 UNet sites: {len(sites)} QuantLinear calls, {launched} "
        f"quant_matmul launches, {len(bad)} differ from the plain version "
        f"{bad[:3]}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("W8A8 UNet: a quantized site disagrees with "
                         "quant_matmul_plain or missed the kernel")


def w8a8_path(records, profiling: bool, float_eps, sd15: dict) -> dict:
    """The SD1.5 W8A8 UNet: built from the SD1.5 seed (the float weights
    quantized), checked with the kernels against plain_path(), each
    quantized site against the kernel's plain version, and compared with
    the float UNet's eps (``float_eps``, same seed and inputs); three
    50-step requests with THEATERGEN_FUSED_INT8 at "1", one at "0"; then,
    at "1", the UNet check and one request with each of flash's other
    routes switched on (SWITCH_REQUESTS)."""
    prev_mode, qz.FUSED_MODE = qz.FUSED_MODE, "1"
    cfg = sd15_config()
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, quantized=True))
    bundle = build_bundle(cfg, "sd15_config(), quantized=True")
    # as the SD1.5 check (bf16 flash and GroupNorm paths round
    # differently); a value the two paths round apart can cross an int8
    # tie, so the difference spreads to later layers as int8 steps
    rel, eps = unet_reference_phase(bundle, 5e-2)
    w8a8_sites_phase(bundle)
    rel_float = ((eps - float_eps).abs().max()
                 / float_eps.abs().max()).item()
    log(f"  W8A8 UNet eps vs the float SD1.5 UNet of the same seed: "
        f"max|diff|/max|ref| {rel_float:.3e}")
    pipe = sd.Text2Img(bundle, num_steps=SD15_STEPS)
    seconds = {}
    for mode, prompts in (("1", PROMPTS), ("0", PROMPTS[:1])):
        qz.FUSED_MODE = mode
        want = counts(flash_attention=10 * SD15_STEPS,
                      group_norm=gn_want(SD15, SD15_STEPS),
                      quant_matmul=QMM_PER_EVAL * SD15_STEPS if mode == "1"
                      else 0)
        seconds[mode] = run_requests(W8A8, pipe, prompts, want, 512,
                                     records)
    qz.FUSED_MODE = "1"
    switch_rel = {}
    for env, attrs, counter in SWITCH_REQUESTS:
        with flash_switches(**attrs):
            log(f"  {env}:")
            switch_rel[env] = unet_reference_phase(bundle, 5e-2)[0]
            want = counts(**{counter: 10 * SD15_STEPS},
                          group_norm=gn_want(SD15, SD15_STEPS),
                          quant_matmul=QMM_PER_EVAL * SD15_STEPS)
            seconds[env] = run_requests(W8A8, pipe, PROMPTS[:1], want, 512,
                                        records)
    peak = torch.cuda.max_memory_allocated()
    log(f"  seconds per request by THEATERGEN_FUSED_INT8 {seconds}; peak "
        f"memory {peak / 2 ** 30:.3f} GiB (bf16 SD1.5 in this call: "
        f"{sd15['seconds_per_request']} s, "
        f"{sd15['peak_bytes'] / 2 ** 30:.3f} GiB)")
    if profiling:
        qz.FUSED_MODE = "1"
        profile(bundle, sd.encode_prompts)
    qz.FUSED_MODE = prev_mode
    return dict(seconds_per_request=seconds, peak_bytes=peak,
                unet_kernels_vs_plain_rel=rel, unet_vs_float_rel=rel_float,
                switch_unet_kernels_vs_plain_rel=switch_rel)


def sdxl_path(records, profiling: bool) -> dict:
    bundle = build_bundle(sdxl_config(), "sdxl_config()")
    # 70 transformer blocks against SD1.5's 16; the paths round
    # differently (h from an fp32 gate vs bf16 gelu and product, fp32
    # logits).  Measured 1.99e-2 on an H100 (PERF.md §6): the SD1.5
    # bound, 2.5x above it, holds here too
    rel, _ = unet_reference_phase(bundle, 5e-2)
    pipe = sdxl.Text2ImgXL(bundle, num_steps=SDXL_STEPS)

    def want():
        return counts(flash_attention=70 * SDXL_STEPS,
                      geglu_matmul=70 * SDXL_STEPS,
                      group_norm=gn_want(SDXL, SDXL_STEPS))

    seconds = run_requests(SDXL, pipe, PROMPTS[:2], want(), 1024, records)
    peak = torch.cuda.max_memory_allocated()
    log(f"  seconds per request {seconds}; peak memory "
        f"{peak / 2 ** 30:.3f} GiB")
    t0 = time.perf_counter()
    log(f"  Text2ImgXL, LCM {LCM_STEPS} steps (the config's scheduler_type "
        f"\"lcm\"):")
    lcm = sdxl.Text2ImgXL(with_pipeline(bundle, scheduler_type="lcm"),
                          num_steps=LCM_STEPS)
    lcm_s = run_requests(SDXL_B1, lcm, PROMPTS[:1], request_want(
        bundle.cfg.unet, 128, step_plan(LCM_STEPS, "lcm")), 1024, records)
    log(f"  SDXL LCM phase: {time.perf_counter() - t0:.1f} s")
    out = dict(seconds_per_request=seconds, peak_bytes=peak,
               unet_kernels_vs_plain_rel=rel, lcm_seconds=lcm_s)
    if profiling:
        profile(bundle, sdxl.encode_prompts_xl)
        out["gn_ab_device_ms"] = gn_ab_profile(bundle, bundle.unet)
        out["gn_ab_requests"] = request_ab(
            SDXL, lambda p: run_requests(SDXL, pipe, [PROMPTS[p % 2]],
                                         want(), 1024, [])[0])
    return out


def path_cfg(model: str):
    """(the IP UNet's config, the latent side, the ControlNet's config or
    None) of a character or final path: SD1.5 at 512 or 768 px (W8A8 for
    CHAR_W8A8), or SDXL at 1024 px, whose final pass takes the
    T2I-Adapter in place of the ControlNet."""
    cfg = sdxl_config() if model in (XL_CHAR, XL_FINAL) else sd15_config()
    ucfg = dataclasses.replace(cfg.unet,
                               ip_num_tokens=cfg.ip_adapter.num_tokens,
                               quantized=model == CHAR_W8A8)
    side = cfg.pipeline.latent_height
    if model in (CHAR_768, FINAL_768):
        side = 768 // 8
    cn = cfg.controlnet.unet if model in (FINAL, FINAL_768) else None
    return ucfg, side, cn


def path_want(model: str, steps: int = SD15_STEPS, **knobs) -> dict:
    """Launches of one request of a character or final path (the final
    pass's ControlNet forwards included) under the step plan of
    ``knobs`` (step_plan), from request_want."""
    ucfg, side, cn = path_cfg(model)
    if cn is None:
        knobs.pop("cn_interval", None)
    return request_want(ucfg, side, step_plan(steps, **knobs), cn)


def character_request(bundle, run, image, i: int, scale: float,
                      records, model: str = CHAR):
    """One 50-step character request under the current switch, counters
    set to 0 just before it and read just after (added to ``records``):
    prompt encoding, image encoding, the IP context and the run.  Checks
    the result's shapes, finiteness and launches; returns its seconds and
    the result."""
    cfg = bundle.cfg
    h, w = cfg.pipeline.latent_height, cfg.pipeline.latent_width
    hw_of = {"mid": h * w // 64, "up": h * w // 16}
    want = path_want(model)
    g = torch.Generator(device="cuda").manual_seed(200 + i)
    lat = torch.randn(1, h, w, 4, device="cuda", generator=g)
    reset_counts()
    t0 = time.perf_counter()
    text = sd.encode_prompts(bundle, PROMPTS[i % len(PROMPTS)])
    ctx = character.ip_context(bundle, text,
                               character.encode_ip_image(bundle, image))
    res = run(lat, ctx, scale)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = read_counts()
    add_launches(records, model, got)
    finite = bool(torch.isfinite(res.trajectory).all()) and all(
        bool(torch.isfinite(m).all()) for m in res.ref_attn)
    shapes = [tuple(m.shape) for m in res.ref_attn]
    want_shapes = [(SD15_STEPS, 8, hw_of[k[0]])
                   for k in cfg.guidance.attn_keys]
    log(f"  {model} character request {i} (switch {gn.FUSED_MODE}, "
        f"ip_scale {scale}): {seconds:.3f} s  launches {got}  trajectory "
        f"{tuple(res.trajectory.shape)}  ref_attn {shapes}  finite {finite}"
        f"  latent std {res.latents.std():.4f}")
    if (tuple(res.trajectory.shape) != (SD15_STEPS + 1, 1, h, w, 4)
            or shapes != want_shapes or not finite):
        raise SystemExit(f"character request {i}: bad result")
    if got != want:
        raise SystemExit(f"character request {i}: launches {got}, "
                         f"want {want}")
    return seconds, res


def character_path(records, profiling: bool) -> tuple:
    """The IP-Adapter character pass: the IP UNet check with the switch at
    "1", encode_ip_image, then the 50-step requests of CHAR_REQUESTS (two
    at "1", one at "0"); with ``profiling`` also the GroupNorm A/B (device
    ms, request pairs, host ms)."""
    prev_mode, gn.FUSED_MODE = gn.FUSED_MODE, "1"
    cfg = sd15_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = init_bundle(cfg, seed=0, device="cuda", with_ip=True,
                         with_vision=True)
    torch.cuda.synchronize()
    n_unet = sum(p.numel() for p in bundle.unet_ip.parameters()) / 1e6
    n_vis = sum(p.numel() for p in bundle.vision.parameters()) / 1e6
    log(f"  init_bundle(sd15_config(), with_ip=True, with_vision=True): "
        f"{time.perf_counter() - t0:.3f} s, IP UNet {n_unet:.1f} M params, "
        f"vision {n_vis:.1f} M, weights "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    ip_scale = torch.tensor(0.4, device="cuda")
    # as the SD1.5 check: bf16 through 16 blocks, plus the kernel's single
    # rounding after the SiLU at 61 norms
    rel, ip_eps = unet_reference_phase(bundle, 5e-2, bundle.unet_ip,
                                       ip_scale=ip_scale)

    image = ip_image()
    embeds = character.encode_ip_image(bundle, image)
    torch.cuda.synchronize()
    ok = (tuple(embeds.shape) == (1, cfg.vision.projection_dim)
          and bool(torch.isfinite(embeds).all()))
    log(f"  encode_ip_image(512² image): {tuple(embeds.shape)} finite "
        f"{ok}  std {embeds.std():.4f}")
    if not ok:
        raise SystemExit("encode_ip_image: bad features")

    run, _ = character.make_character_pipeline(
        bundle, SD15_STEPS, use_ip=True, capture_ref_attn=True)
    seconds = collections.defaultdict(list)
    for i, (mode, scale) in enumerate(CHAR_REQUESTS):
        gn.FUSED_MODE = mode
        seconds[mode].append(character_request(bundle, run, image, i, scale,
                                               records)[0])
    peak = torch.cuda.max_memory_allocated()
    log(f"  seconds per request by switch {dict(seconds)}; peak memory "
        f"{peak / 2 ** 30:.3f} GiB")
    out = dict(seconds_per_request=dict(seconds), peak_bytes=peak,
               unet_kernels_vs_plain_rel=rel)
    if profiling:
        out["gn_ab_device_ms"] = gn_ab_profile(bundle, bundle.unet_ip,
                                               ip_scale=ip_scale)
        out["gn_ab_requests"] = request_ab(
            CHAR, lambda p: character_request(bundle, run, image, 10 + p,
                                              0.4, [])[0])
        out.update(host_ab(bundle, ip_scale=ip_scale))
    gn.FUSED_MODE = prev_mode
    return out, ip_eps


def ip_image():
    """The character requests' seeded 512² reference image."""
    g = torch.Generator(device="cuda").manual_seed(7)
    return torch.rand(1, 512, 512, 3, device="cuda", generator=g)


def w8a8_character_path(records, float_ip_eps) -> dict:
    """The character pass on the W8A8 IP UNet:
    ``init_bundle(sd15_config()`` with ``unet.quantized``, ``with_ip=True,
    with_vision=True)`` (the float weights of the same seed, quantized),
    ``THEATERGEN_FUSED_INT8`` at "1".  Its IP UNet with the kernels is held
    to ``plain_path()`` as the W8A8 UNet is, and to the float IP UNet's eps
    (``float_ip_eps``, same inputs) within W8A8_FLOAT_BOUND; then one
    50-step request at ip_scale 0.4, its launches from request_want."""
    prev_mode, qz.FUSED_MODE = qz.FUSED_MODE, "1"
    cfg = sd15_config()
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, quantized=True))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = init_bundle(cfg, seed=0, device="cuda", with_ip=True,
                         with_vision=True)
    torch.cuda.synchronize()
    n_q = sum(isinstance(m, QuantLinear) for m in bundle.unet_ip.modules())
    log(f"  init_bundle(sd15_config(), quantized=True, with_ip=True, "
        f"with_vision=True): {time.perf_counter() - t0:.3f} s, "
        f"{n_q} QuantLinear in the IP UNet, weights "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    rel, eps = unet_reference_phase(bundle, 5e-2, bundle.unet_ip,
                                    ip_scale=torch.tensor(0.4, device="cuda"))
    rel_float = ((eps - float_ip_eps).abs().max()
                 / float_ip_eps.abs().max()).item()
    ok = rel_float <= W8A8_FLOAT_BOUND
    log(f"  W8A8 IP UNet eps vs the float IP UNet of the same seed: "
        f"max|diff|/max|ref| {rel_float:.3e} (bound {W8A8_FLOAT_BOUND:g})  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the W8A8 IP UNet is off the float IP UNet")
    run, _ = character.make_character_pipeline(
        bundle, SD15_STEPS, use_ip=True, capture_ref_attn=True)
    seconds, _ = character_request(bundle, run, ip_image(), 0, 0.4, records,
                                   CHAR_W8A8)
    peak = torch.cuda.max_memory_allocated()
    log(f"  seconds per request {seconds:.3f}; peak memory "
        f"{peak / 2 ** 30:.3f} GiB")
    qz.FUSED_MODE = prev_mode
    return dict(seconds_per_request=seconds, peak_bytes=peak,
                unet_kernels_vs_plain_rel=rel, unet_vs_float_rel=rel_float)


def xl_path(records) -> dict:
    """The SDXL turn's models on one bundle, ``init_bundle(sdxl_config(),
    with_ip=True, with_vision=True, with_t2i_adapter=True)``: the
    T2I-Adapter's features of a seeded 1024² hint (no kernel), the XL IP
    UNet with pooled text, time ids and those features as level residuals
    against ``plain_path()`` (the SDXL bound); the wall ms per evaluation
    of the base and the IP UNet with the residuals, in turns; two 30-step
    ``Text2ImgXL`` requests with the hint and two without, in turns (ABBA),
    each with the SDXL request's launches; then each UNet's device ms per
    evaluation and the IP UNet's host-side op table (torch.profiler)."""
    cfg = sdxl_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = init_bundle(cfg, seed=0, device="cuda", with_ip=True,
                         with_vision=True, with_t2i_adapter=True)
    torch.cuda.synchronize()
    n_ada = sum(p.numel() for p in bundle.t2i_adapter.parameters()) / 1e6
    log(f"  init_bundle(sdxl_config(), with_ip=True, with_vision=True, "
        f"with_t2i_adapter=True): {time.perf_counter() - t0:.3f} s, "
        f"T2I-Adapter {n_ada:.1f} M params, weights "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    g = torch.Generator(device="cuda").manual_seed(9)
    hint = torch.rand(cfg.pipeline.height, cfg.pipeline.width, 3,
                      device="cuda", generator=g)
    reset_counts()
    feats = sdxl.adapter_features(bundle, hint)
    torch.cuda.synchronize()
    adapter_ms = time_ms(lambda: sdxl.adapter_features(bundle, hint), 5)
    shapes = [tuple(f.shape) for f in feats]
    side = cfg.pipeline.latent_height
    want_shapes = [(1, c, side >> i, side >> i)
                   for i, c in enumerate(cfg.unet.block_out_channels)]
    ok = (shapes == want_shapes and read_counts() == counts()
          and all(bool(torch.isfinite(f).all()) for f in feats))
    log(f"  T2I-Adapter features of the 1024² hint: {shapes}, "
        f"{adapter_ms:.3f} ms a call, no kernel launched: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("T2I-Adapter: bad features")
    ip_scale = torch.tensor(0.4, device="cuda")
    lev = t2i_adapter.tile_features(feats, 2)
    # the SDXL UNet's bound: 70 blocks of bf16 that the two paths round
    # differently; the adapter's features enter both alike
    rel, _ = unet_reference_phase(bundle, 5e-2, bundle.unet_ip,
                                  ip_scale=ip_scale, level_residuals=lev)
    x, t, ctx, cond = unet_inputs(bundle, 5, 501, 77 + 4)
    evals = {
        "unet": lambda: bundle.unet(x, t, ctx[:, :77], level_residuals=lev,
                                    **cond),
        "unet_ip": lambda: bundle.unet_ip(x, t, ctx, ip_scale=ip_scale,
                                          level_residuals=lev, **cond)}
    # wall ms per evaluation (5 back to back, the loop's pace), the base
    # and the IP UNet in turns, before any profiler runs in this phase
    wall = collections.defaultdict(list)
    with torch.no_grad():
        for name in ("unet", "unet_ip", "unet_ip", "unet"):
            wall[name].append(time_ms(evals[name], 5, 1))
    pipe = sdxl.Text2ImgXL(bundle, num_steps=SDXL_STEPS)
    want = counts(flash_attention=70 * SDXL_STEPS,
                  geglu_matmul=70 * SDXL_STEPS,
                  group_norm=gn_want(SDXL, SDXL_STEPS))
    # the hinted request, and the same request without the hint, in turns
    seconds = collections.defaultdict(list)
    for i, hinted in enumerate((True, False, False, True)):
        seconds["hint" if hinted else "no_hint"] += run_requests(
            XL_HINT if hinted else SDXL,
            (lambda gen, p: pipe(gen, p, hint=hint)) if hinted else pipe,
            [PROMPTS[i % 2]], want, cfg.pipeline.height, records)
    peak = torch.cuda.max_memory_allocated()
    log(f"  seconds per request with and without the hint, in turns: "
        f"{json.dumps(seconds)}; peak memory {peak / 2 ** 30:.3f} GiB")
    with torch.no_grad():
        device = {name: device_ms(fn) for name, fn in evals.items()}
        host_table(evals["unet_ip"])
    eval_ms = dict(device=device, wall=dict(wall))
    log(f"  evaluation with level residuals, batch 2, ms: "
        f"{json.dumps(eval_ms)}")
    log(f"  latent guidance in the XL character pass, {XL_GUIDED_STEPS} "
        f"Euler-Ancestral steps at 1024 px:")
    guided = xl_guided_request(bundle, ip_image(), records)
    return dict(seconds_per_request=dict(seconds), peak_bytes=peak,
                unet_kernels_vs_plain_rel=rel, eval_ms=eval_ms,
                adapter_ms=adapter_ms, guided_request=guided)


def host_table(fn, rows: int = 15) -> None:
    """The host side of one call of ``fn``: torch.profiler's ops by their
    own CPU time, with their device time beside it."""
    from torch.profiler import ProfilerActivity, profile as prof
    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    log(p.key_averages().table(sort_by="self_cpu_time_total",
                               row_limit=rows))


def final_inputs(bundle, seed: int):
    """Inputs of one final-pass evaluation at the bundle's canvas (CFG
    batch 2): latents, timesteps 981, the IP context (text + IP tokens)
    and a hint image in [0, 1], NCHW."""
    cfg = bundle.cfg
    px, h = cfg.pipeline.height, cfg.pipeline.latent_height
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(2, 4, h, h, device="cuda", generator=g)
    t = torch.full((2,), 981, device="cuda", dtype=torch.long)
    ctx = torch.randn(2, cfg.text.max_length + bundle.unet_ip.cfg.ip_num_tokens,
                      cfg.unet.cross_attention_dim, device="cuda",
                      generator=g)
    cond = torch.rand(2, 3, px, px, device="cuda", generator=g)
    return x, t, ctx, cond


def final_reference_phase(bundle) -> dict:
    """One full-size ControlNet evaluation and one IP UNet evaluation with
    its residuals, each with the kernels against plain_path() (the UNet
    given the kernel path's residuals in both runs)."""
    px, text_len = bundle.cfg.pipeline.height, bundle.cfg.text.max_length
    x, t, ctx, cond = final_inputs(bundle, px)
    ip_scale = torch.tensor(IP_SCALE_FINAL, device="cuda")
    out = {}
    with torch.no_grad():
        down, mid = bundle.controlnet(x, t, ctx[:, :text_len], cond)
        with plain_path():
            down_p, mid_p = bundle.controlnet(x, t, ctx[:, :text_len], cond)
        fast = torch.cat([r.float().flatten() for r in down + (mid,)])
        plain = torch.cat([r.float().flatten() for r in down_p + (mid_p,)])
        out["controlnet"] = (fast, plain)
        eps = bundle.unet_ip(x, t, ctx, ip_scale=ip_scale,
                             down_residuals=down, mid_residual=mid).float()
        with plain_path():
            eps_p = bundle.unet_ip(x, t, ctx, ip_scale=ip_scale,
                                   down_residuals=down,
                                   mid_residual=mid).float()
        out["unet_with_residuals"] = (eps, eps_p)
    rels = {}
    for what, (a, b) in out.items():
        rels[what] = ((a - b).abs().max() / b.abs().max()).item()
        ok = bool(torch.isfinite(a).all()) and rels[what] <= 5e-2
        log(f"  {px} px {what}, kernels vs plain path: max|diff|/max|ref| "
            f"{rels[what]:.3e} (bound 5e-2)  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{px} px {what}: kernels disagree with the "
                             f"plain path")
    return rels


def plain_attention_ms(bundle) -> dict:
    """Device ms of one plain self-attention call (CUDA events, 10 back
    to back) at each UNet level whose self-attention has 1024 tokens or
    more but lies outside the flash gate (768 px: level 1, 2304 tokens),
    keyed by its [B, S, H, D] shape."""
    ucfg, h = bundle.unet_ip.cfg, bundle.cfg.pipeline.latent_height
    out = {}
    for level, ch in enumerate(ucfg.block_out_channels):
        heads, s = ucfg.heads_at(level), (h >> level) ** 2
        if (not ucfg.attention_levels[level] or s < fa.MIN_SEQ
                or fa.supported(s, s, heads, ch // heads)):
            continue
        g = torch.Generator(device="cuda").manual_seed(s)
        q, k, v = (randn(g, 2, s, heads, ch // heads) for _ in range(3))
        shape = (2, s, heads, ch // heads)
        out[str(list(shape))] = time_ms(
            lambda: multi_head_attention(q, k, v), 10)
        log(f"  plain attention {list(shape)} (outside the flash gate): "
            f"{out[str(list(shape))]:.5f} ms")
    return out


def final_eval_times(bundle) -> dict:
    """Wall ms per final-pass evaluation (ControlNet + IP UNet, batch 2;
    CUDA events over 5 back to back: the loop's pace, which the host sets)
    and its device ms (torch.profiler, one evaluation: the sum of the
    kernels' self device time, the kernels that take most of it, and the
    shares of flash, ff_geglu, group_norm and PyTorch's GroupNorm, which
    takes the sites the TPU gate leaves out)."""
    from torch.profiler import ProfilerActivity, profile as prof
    px, text_len = bundle.cfg.pipeline.height, bundle.cfg.text.max_length
    x, t, ctx, cond = final_inputs(bundle, px + 1)
    emb = bundle.controlnet.embed_hint(cond[:1])
    ip_scale = torch.tensor(IP_SCALE_FINAL, device="cuda")

    def one():
        down, mid = bundle.controlnet(x, t, ctx[:, :text_len],
                                      cond_embed=emb)
        return bundle.unet_ip(x, t, ctx, ip_scale=ip_scale,
                              down_residuals=down, mid_residual=mid)

    with torch.no_grad():
        wall = time_ms(one, 5, 1)
        with prof(activities=[ProfilerActivity.CUDA]) as p:
            one()
            torch.cuda.synchronize()
    kernels = collections.Counter()
    ours = collections.Counter()
    for e in p.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if not e.key.startswith("aten::") and us > 0:
            kernels[e.key[:60]] += us / 1e3
            for name, tag in (("ff_geglu", "ff_geglu_kernel"),
                              ("flash_attention", "flash_fwd_kernel")):
                if tag in e.key:
                    ours[name] += us / 1e3
            norm = gn_kernel_kind(e.key)
            if norm:
                ours[norm] += us / 1e3
    device = sum(kernels.values())
    top = dict(kernels.most_common(8))
    shares = {name: dict(ms=ms, share=ms / device) for name, ms in
              ours.items()}
    log(f"  {px} px final-pass evaluation (ControlNet + IP UNet): wall "
        f"{wall:.3f} ms, device {device:.3f} ms; device ms by kernel "
        f"{json.dumps(top)}")
    log(f"  {px} px final-pass evaluation, the redesigned kernels' (and "
        f"PyTorch's GroupNorm's) device ms and share: {json.dumps(shares)}")
    return dict(wall_ms=wall, device_ms=device, top_kernels_ms=top,
                kernel_shares=shares,
                plain_attention_ms=plain_attention_ms(bundle))


def final_request(bundle, run, composed, frozen_mask, cond_img, ip_image,
                  model: str, records, want: dict = None) -> dict:
    """One final request, counters set to 0 just before it and read just
    after: the overall prompt's context, ``ip_context`` with the first
    character's image, the 50-step runner and the decode.  Checks that the
    frozen mask leaves both a frozen and a free region, the image, the
    trajectory's shape, the frozen region of every step below FROZEN_STEPS
    bit for bit against the composed trajectory, the free region moved
    off it (the denoiser's side of the blend), and the launches (``want``,
    by default the path's)."""
    cfg = bundle.cfg
    h, w, px = (cfg.pipeline.latent_height, cfg.pipeline.latent_width,
                cfg.pipeline.height)
    on = frozen_mask > 0
    if not 0 < int(on.sum()) < h * w:
        raise SystemExit(f"{model} final request: the frozen mask covers "
                         f"{int(on.sum())} of {h * w} latent pixels; the "
                         f"check needs both sides of the blend")
    want = path_want(model) if want is None else want
    reset_counts()
    t0 = time.perf_counter()
    neg = "incohesive, edge shadow, blurry"
    text = sd.encode_prompts(bundle, OVERALL_PROMPT, neg)
    ctx = character.ip_context(bundle, text,
                               character.encode_ip_image(bundle, ip_image))
    latents, traj = run(composed, frozen_mask, FROZEN_STEPS, ctx, text,
                        cond_img, IP_SCALE_FINAL)
    img = sd.decode_with(bundle.vae, cfg.vae.scaling_factor, latents)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = read_counts()
    add_launches(records, model, got)
    frozen_equal = all(
        torch.equal(traj[j, 0].permute(2, 0, 1)[:, on],
                    composed[j, 0].permute(2, 0, 1)[:, on])
        for j in range(FROZEN_STEPS + 1))
    # where the mask is off, step 1 holds the DDIM step's output, not the
    # composed trajectory (0 there past step 0)
    free_moved = not torch.equal(traj[1, 0].permute(2, 0, 1)[:, ~on],
                                 composed[1, 0].permute(2, 0, 1)[:, ~on])
    finite = bool(torch.isfinite(img).all())
    in_range = bool(img.min() >= 0.0 and img.max() <= 1.0)
    log(f"  {model} final request: {seconds:.3f} s  launches {got}  image "
        f"{tuple(img.shape)} finite {finite} range [{img.min():.4f}, "
        f"{img.max():.4f}] std {img.std():.4f}  trajectory "
        f"{tuple(traj.shape)}  frozen region ({int(on.sum())} of {h * w} "
        f"latent pixels) equal to the composition for steps 0..{FROZEN_STEPS}"
        f": {frozen_equal}  free region off it at step 1: {free_moved}")
    if (tuple(img.shape) != (1, px, px, 3) or not finite or not in_range
            or tuple(traj.shape) != (SD15_STEPS + 1, 1, h, w, 4)
            or not bool(torch.isfinite(traj).all())):
        raise SystemExit(f"{model} final request: bad result")
    if not frozen_equal:
        raise SystemExit(f"{model} final request: the frozen region differs "
                         f"from the composed trajectory")
    if not free_moved:
        raise SystemExit(f"{model} final request: the free region kept the "
                         f"composed trajectory; the denoiser's step is lost")
    if got != want:
        raise SystemExit(f"{model} final request: launches {got}, want "
                         f"{want}")
    return dict(seconds=seconds, image_std=img.std().item())


def back_half(bundle, records, char_model: str, model: str,
              chars_spec, switch_requests=()) -> dict:
    """At the bundle's canvas: the final pass checked against
    plain_path(), the characters of ``chars_spec`` ((ip_scale, layout box)
    each: 50-step character requests, decoded), their masks from the
    step-mean reference maps, the composition program, one final request,
    and the final pass's evaluation times; then, for each of
    ``switch_requests`` (SWITCH_REQUESTS_768), the check against
    plain_path() and one final request with that flash switch set, its
    level-0 launches on the switch's counter."""
    cfg = bundle.cfg
    px = cfg.pipeline.height
    h, w = cfg.pipeline.latent_height, cfg.pipeline.latent_width
    k = cfg.pipeline.max_objects
    torch.cuda.reset_peak_memory_stats()
    rels = final_reference_phase(bundle)
    g = torch.Generator(device="cuda").manual_seed(17)
    ref_image = torch.rand(1, 512, 512, 3, device="cuda", generator=g)
    run_char, _ = character.make_character_pipeline(
        bundle, SD15_STEPS, use_ip=True, capture_ref_attn=True)
    chars, char_seconds = [], []
    for i, (scale, box) in enumerate(chars_spec):
        sec, res = character_request(bundle, run_char, ref_image, 20 + i,
                                     scale, records, char_model)
        char_seconds.append(sec)
        image = sd.decode_with(bundle.vae, cfg.vae.scaling_factor,
                               res.latents)
        box = torch.tensor(box, device="cuda")
        maps = theater.aggregate_attn(res.ref_attn, SD15_STEPS)
        m_lat, m_pix = theater._attn_mask_fallback(
            maps, geometry.centered_box(box), h, w, px, px)
        chars.append(dict(traj=res.trajectory, m_lat=m_lat, m_pix=m_pix,
                          image=image[0], box=box))
        log(f"  character {i}: mask {int(m_lat.sum())} of {h * w} latent "
            f"pixels, layout box {tuple(round(v, 3) for v in box.tolist())}")
    pad = k - len(chars)
    t0 = time.perf_counter()

    def stack(key, like):
        return torch.stack([c[key] for c in chars]
                           + [torch.zeros_like(like)] * pad)

    g_bg = torch.Generator(device="cuda").manual_seed(1000)
    composed, collage, cond_img, frozen_mask = theater._compose_program()(
        stack("traj", chars[0]["traj"]), stack("m_lat", chars[0]["m_lat"]),
        stack("m_pix", chars[0]["m_pix"]), stack("image", chars[0]["image"]),
        stack("box", chars[0]["box"]),
        torch.arange(k, device="cuda") < len(chars),
        torch.randn(1, h, w, 4, device="cuda", generator=g_bg))
    torch.cuda.synchronize()
    compose_s = time.perf_counter() - t0
    log(f"  composition program: {compose_s:.3f} s, frozen mask "
        f"{int(frozen_mask.sum())} of {h * w} latent pixels, collage mean "
        f"{collage.mean():.4f}, lineart mean {cond_img.mean():.4f}")
    run, _ = final.make_final_pipeline(bundle, SD15_STEPS)
    req = final_request(bundle, run, composed, frozen_mask, cond_img,
                        chars[0]["image"][None], model, records)
    peak = torch.cuda.max_memory_allocated()
    times = final_eval_times(bundle)
    log(f"  {px} px: character requests {char_seconds} s, final request "
        f"{req['seconds']:.3f} s, peak memory {peak / 2 ** 30:.3f} GiB")
    switched = {}
    for env, attrs, counter in switch_requests:
        with flash_switches(**attrs):
            log(f"  {env}:")
            rels_sw = final_reference_phase(bundle)
            flash = PER_EVAL[model]["flash_attention_long"]
            want = counts(**{counter: flash * SD15_STEPS},
                          ff_geglu=PER_EVAL[model]["ff_geglu"] * SD15_STEPS,
                          group_norm=gn_want(model, SD15_STEPS))
            switched[env] = dict(kernels_vs_plain_rel=rels_sw,
                                 final_request=final_request(
                                     bundle, run, composed, frozen_mask,
                                     cond_img, chars[0]["image"][None],
                                     model, records, want))
    return dict(kernels_vs_plain_rel=rels, character_seconds=char_seconds,
                compose_seconds=compose_s, final_request=req,
                peak_bytes=peak, final_eval=times, switched=switched)


def device_ms(fn) -> float:
    """Device ms of one call of ``fn``: the kernels' self device time in
    torch.profiler, summed."""
    from torch.profiler import ProfilerActivity, profile as prof
    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in p.key_averages()
               if not e.key.startswith("aten::")) / 1e3


def deepcache_phase(bundle) -> dict:
    """DeepCache on the card, at 512 px on the back half's IP UNet with
    ControlNet residuals: one full evaluation with
    ``return_deep_cache=True``, then the shallow evaluation from that
    cache at the same inputs, which must agree with the full one within
    1e-2·max|ref| (the same computation: the shallow forward recomputes
    the encoder prefix and the last up block with the same kernels at the
    same shapes), and the shallow evaluation with the kernels against
    itself under plain_path() within 5e-2·max|ref|.  Each of the four
    evaluation kinds (CFG or cond-only, full or shallow) launches what
    eval_launches derives, and the ControlNet at batch 1 too.  Then the
    device and wall ms of a shallow evaluation beside a full one (batch 2;
    wall: CUDA events over 5 back to back)."""
    t0 = time.perf_counter()
    text_len = bundle.cfg.text.max_length
    x, t, ctx, cond = final_inputs(bundle, 33)
    unet, ucfg = bundle.unet_ip, bundle.unet_ip.cfg
    ip_scale = torch.tensor(IP_SCALE_FINAL, device="cuda")
    bad, launches = [], {}

    def counted(what, want, fn):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = read_counts()
        launches[what] = got
        if got != counts(**want):
            bad.append(f"{what}: launches {got}, want {counts(**want)}")
        return out

    with torch.no_grad():
        rows = {}
        for b in (2, 1):
            xb, tb_, cb = x[-b:], t[-b:], ctx[-b:]
            res = counted(f"controlnet b{b}", eval_launches(
                bundle.controlnet.cfg, 64, b, encoder_only=True),
                lambda: bundle.controlnet(xb, tb_, cb[:, :text_len],
                                          cond[-b:]))
            kw = dict(ip_scale=ip_scale, down_residuals=res[0],
                      mid_residual=res[1])
            full, cache = counted(f"full b{b}", eval_launches(ucfg, 64, b),
                                  lambda: unet(xb, tb_, cb,
                                               return_deep_cache=True, **kw))
            shallow = counted(f"shallow b{b}",
                              eval_launches(ucfg, 64, b, shallow=True),
                              lambda: unet(xb, tb_, cb, deep_cache=cache,
                                           **kw))
            rows[b] = (full.float(), shallow.float(), cache, kw)
        full, shallow, cache, kw = rows[2]
        with plain_path():
            plain = unet(x, t, ctx, deep_cache=cache, **kw).float()
        err = (shallow - full).abs().max().item()
        bit_equal = bool(torch.equal(shallow, full))
        check(err, full.abs().max().item(),
              f"shallow evaluation from its own cache vs the full one "
              f"(bit for bit: {bit_equal})")
        rel = ((shallow - plain).abs().max() / plain.abs().max()).item()
        ok = bool(torch.isfinite(shallow).all()) and rel <= 5e-2
        log(f"  shallow evaluation, kernels vs plain path: max|diff|/max|ref| "
            f"{rel:.3e} (bound 5e-2)  {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append("the shallow evaluation disagrees with its plain path")
        times = {}
        for kind, fn in (
                ("full", lambda: unet(x, t, ctx, return_deep_cache=True,
                                      **kw)),
                ("shallow", lambda: unet(x, t, ctx, deep_cache=cache,
                                         **kw))):
            times[kind] = dict(wall_ms=time_ms(fn, 5, 1),
                               device_ms=device_ms(fn))
    log(f"  launches per evaluation kind: {json.dumps(launches)}")
    log(f"  IP UNet evaluation (batch 2, with residuals), full vs shallow: "
        f"{json.dumps(times)}")
    phase_s = time.perf_counter() - t0
    log(f"  DeepCache phase: {phase_s:.1f} s")
    if bad:
        raise SystemExit("DeepCache: " + "; ".join(bad))
    return dict(shallow_vs_full_max_abs_err=err, shallow_bit_equal=bit_equal,
                shallow_kernels_vs_plain_rel=rel, launches=launches,
                eval_times=times, phase_seconds=phase_s)


def packed_route_phase(bundle) -> dict:
    """One 512-px final-pass evaluation (ControlNet + IP UNet) with
    THEATERGEN_FLASH_BSHD=1: its self-attentions (4096 and 1024 tokens) take
    the packed projections first, so every launch stays on row 1's
    counter."""
    px, text_len = bundle.cfg.pipeline.height, bundle.cfg.text.max_length
    x, t, ctx, cond = final_inputs(bundle, px + 2)
    want = counts(flash_attention=PER_EVAL[FINAL]["flash_attention"],
                  ff_geglu=PER_EVAL[FINAL]["ff_geglu"],
                  group_norm=gn_want(FINAL, 1))
    with flash_switches(BSHD_NATIVE=True), torch.no_grad():
        reset_counts()
        down, mid = bundle.controlnet(x, t, ctx[:, :text_len], cond)
        bundle.unet_ip(x, t, ctx, ip_scale=torch.tensor(IP_SCALE_FINAL,
                                                        device="cuda"),
                       down_residuals=down, mid_residual=mid)
        torch.cuda.synchronize()
        got = read_counts()
    log(f"  {px} px final-pass evaluation with THEATERGEN_FLASH_BSHD=1: "
        f"launches {got}  {'ok' if got == want else 'FAIL'}")
    if got != want:
        raise SystemExit(f"{px} px with THEATERGEN_FLASH_BSHD=1: launches "
                         f"{got}, want {want}")
    return got


def final_paths(records) -> dict:
    """The back half at 512 px (two characters) and 768 px (one), on one
    bundle: 768 px is the same modules under a config whose
    ``pipeline.height``/``width`` are replaced."""
    cfg = sd15_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = init_bundle(cfg, seed=0, device="cuda", with_ip=True,
                         with_vision=True, with_controlnet=True)
    torch.cuda.synchronize()
    n_cn = sum(p.numel() for p in bundle.controlnet.parameters()) / 1e6
    log(f"  init_bundle(sd15_config(), with_ip=True, with_vision=True, "
        f"with_controlnet=True): {time.perf_counter() - t0:.3f} s, "
        f"ControlNet {n_cn:.1f} M params, weights "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    out = {FINAL: back_half(bundle, records, CHAR, FINAL, FINAL_CHARS[512])}
    out[FINAL]["bshd_launches_one_eval"] = packed_route_phase(bundle)
    log("  DeepCache on the IP UNet (512 px, ControlNet residuals):")
    out[FINAL]["deepcache"] = deepcache_phase(bundle)
    gc.collect()
    torch.cuda.empty_cache()
    cfg768 = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, height=768, width=768))
    out[FINAL_768] = back_half(dataclasses.replace(bundle, cfg=cfg768),
                               records, CHAR_768, FINAL_768, FINAL_CHARS[768],
                               SWITCH_REQUESTS_768)
    return out


def turn_want(attempts: int, steps: int = SD15_STEPS, xl: bool = False,
              **knobs) -> dict:
    """Launches of one turn: each character attempt is a character
    request, and the turn ends in one final request, each of ``steps``
    under the step plan of ``knobs`` (SD1.5's paths, or with ``xl`` the
    SDXL turn's)."""
    per_attempt = path_want(XL_CHAR if xl else CHAR, steps, **knobs)
    final_req = path_want(XL_FINAL if xl else FINAL, steps, **knobs)
    return {k: attempts * per_attempt[k] + final_req[k] for k in COUNTERS}


def turn_path(records, label: str = "", flags=(), steps: int = SD15_STEPS,
              knobs=None, xl: bool = False, images=None,
              guided: bool = False) -> dict:
    """The serial story loop through the port's CLI,
    ``cli.generate.main``, over dialogue_0 of data/sample/story.json:
    SD1.5 at 512 px (or, with ``xl``, SDXL at 1024 px, ``flags`` carrying
    ``--sd_version xl``), full width and depth on random weights,
    ``steps`` steps (50 DDIM by default; ``flags`` adds the CLI's knob
    flags and ``knobs`` their step plan), frozen_step_ratio 0.5, into an
    output tree and character DB under build/chip_smoke_turn[_xl][_label]/
    (emptied first: the CLI resumes by existence).  Every counter is set to 0 just before
    each turn and read just after it (Theater.run_turn wrapped here); the
    turn's character attempts are read from its PhaseTimer.  Fails unless
    every turn ran (none quarantined), its images are finite, in [0, 1]
    and of the canvas's side, the DB hits are TURN_HITS, each turn's
    launches are turn_want, and, with ``--profile``, the trace directory
    holds a non-empty file.  ``images``, a list, receives each turn's
    images (the turn's, then its characters').  With ``guided``
    (``--guidance`` in ``flags``) each turn's guidance iterations are
    recorded per pass and step, and its launches are turn_want plus one
    cond-only IP UNet evaluation per iteration."""
    from theatergen_tpu_torch.cli import generate
    from theatergen_tpu_torch.db import CharacterDB

    knobs = knobs or {}
    side = 1024 if xl else 512
    model = (XL_TURN if xl else TURN) + (f"_{label}" if label else "")
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_turn" + ("_xl" if xl else "")
                        + (f"_{label}" if label else ""))
    shutil.rmtree(root, ignore_errors=True)
    out_dir, db_dir = os.path.join(root, "out"), os.path.join(root, "db")
    turns, real = [], theater.Theater.run_turn

    def counted_turn(self, spec, seed, **kw):
        before = self.timer.counts().get("char.denoise_decode", 0)
        reset_counts()
        with guidance_log() as calls:
            t0 = time.perf_counter()
            res = real(self, spec, seed, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got = read_counts()
        add_launches(records, model, got)
        attempts = self.timer.counts()["char.denoise_decode"] - before
        images_ = [res.image] + res.so_images
        ok_images = all(
            im.shape == (side, side, 3) and bool(np.isfinite(im).all())
            and im.min() >= 0.0 and im.max() <= 1.0 for im in images_)
        turns.append(dict(seconds=res.seconds, wall_s=wall,
                          attempts=attempts, launches=got,
                          db_hits=res.db_hits, detections=res.detections,
                          images_ok=ok_images,
                          guidance_iterations=passes_of(calls)))
        if images is not None:
            images.append(images_)
        log(f"  turn {len(turns)}: {wall:.3f} s  characters "
            f"{len(res.so_images)}  attempts {attempts}  DB hits "
            f"{res.db_hits}  detections {res.detections}  launches {got}  "
            f"images finite, in [0, 1], {side}²: {ok_images}"
            + (f"  guidance iterations per pass and step "
               f"{turns[-1]['guidance_iterations']}" if guided else ""))
        return res

    torch.cuda.reset_peak_memory_stats()
    theater.Theater.run_turn = counted_turn
    try:
        generate.main([
            "--dataset_path", os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "data", "sample"),
            "--task", "story", "--max_dialogues", "1",
            "--num_steps", str(steps), "--frozen_step_ratio", "0.5",
            "--base_save_dir", out_dir, "--database_path_base", db_dir,
            *flags])
    finally:
        theater.Theater.run_turn = real
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out_dir, "story", "run0", "run_log.jsonl")) as f:
        events = [json.loads(line) for line in f]
    logged = [e for e in events if e["event"] == "turn"]
    (dialogue,) = [e for e in events if e["event"] == "dialogue"]
    store = CharacterDB(os.path.join(db_dir, "story", "dialogue_0")).store_kind
    log(f"  dialogue: {dialogue['seconds']} s; seconds per turn "
        f"{[round(t['wall_s'], 3) for t in turns]}; peak memory "
        f"{peak / 2 ** 30:.3f} GiB; embedding store: {store}")
    log(f"  phase summary: {json.dumps(dialogue['phase_summary'])}")
    bad = []
    if [e["turn"] for e in logged] != [f"turn {i}" for i in range(1, 5)]:
        bad.append(f"turn events {[e['turn'] for e in logged]}")
    if any(e["event"] == "quarantine" for e in events):
        bad.append("a turn was quarantined")
    for i, t in enumerate(turns):
        if not t["images_ok"]:
            bad.append(f"turn {i + 1}: bad image")
        if t["db_hits"] != TURN_HITS[i]:
            bad.append(f"turn {i + 1}: DB hits {t['db_hits']}, want "
                       f"{TURN_HITS[i]}")
        want = turn_want(t["attempts"], steps, xl, **knobs)
        iters = sum(map(sum, t["guidance_iterations"]))
        per_iter = guided_iter_want(XL_CHAR if xl else CHAR)
        want = {k: want[k] + iters * per_iter[k] for k in COUNTERS}
        if guided != bool(iters) or (guided and len(
                t["guidance_iterations"]) != t["attempts"] + 1):
            bad.append(f"turn {i + 1}: guidance ran in "
                       f"{len(t['guidance_iterations'])} passes")
        if t["launches"] != want:
            bad.append(f"turn {i + 1}: launches {t['launches']}, want "
                       f"{want}")
    for t_idx in range(len(logged)):
        turn_dir = os.path.join(out_dir, "story", "run0", "dialogue_0",
                                f"turn {t_idx + 1}")
        for name in sorted(os.listdir(turn_dir)):
            if png.read_png(os.path.join(turn_dir, name)).shape != (side,
                                                                    side, 3):
                bad.append(f"turn {t_idx + 1}/{name}: not {side}²")
    if len(turns) != 4:
        bad.append(f"{len(turns)} turns ran")
    trace = None
    if "--profile" in flags:
        tdir = os.path.join(out_dir, "story", "run0", "profile")
        files = [os.path.join(tdir, f) for f in sorted(os.listdir(tdir))] \
            if os.path.isdir(tdir) else []
        trace = {os.path.basename(f): os.path.getsize(f) for f in files}
        log(f"  --profile trace {tdir}: {trace} bytes (deleted now)")
        if not any(trace.values()):
            bad.append("the --profile trace directory is missing or empty")
        shutil.rmtree(tdir, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    log(f"  {model}: {phase_s:.1f} s for the phase (the bundle's build "
        f"included)")
    log(f"  turn checks: {'ok' if not bad else 'FAIL ' + '; '.join(bad)}")
    if bad:
        raise SystemExit(f"the story turn {model} failed: " + "; ".join(bad))
    return dict(turns=turns, dialogue_seconds=dialogue["seconds"],
                phase_summary=dialogue["phase_summary"], peak_bytes=peak,
                store=store, flags=list(flags), steps=steps,
                phase_seconds=phase_s, profile_trace_bytes=trace)


def loaded_mismatches(src, loaded) -> tuple:
    """The entries of the bundle ``load_bundle`` read from ``src``'s
    checkpoint directory that differ from their source: the fp16 files'
    the source rounded to fp16 and cast to the module's dtype, SAM's and
    the annotator's (fp32 files) the source itself, the IP UNet the UNet
    file's entries and the IP file's to_k_ip/to_v_ip.  Returns (names,
    elements compared)."""
    bad, n = [], 0
    unet = src.unet.state_dict()
    for field in ("unet", "unet_ip", "vae", "text", "vision", "controlnet",
                  "image_proj", "sam", "lineart"):
        ref = getattr(src, field).state_dict()
        for k, v in getattr(loaded, field).state_dict().items():
            want = unet[k] if field == "unet_ip" and "_ip." not in k \
                else ref[k]
            if field not in ("sam", "lineart"):
                want = want.to(torch.float16)
            n += v.numel()
            if not torch.equal(v, want.to(v.dtype)):
                bad.append(f"{field}.{k}")
    return bad, n


def snapshot_mismatches(a, b) -> list:
    """Modules or entries of two bundles that differ in presence, dtype or
    any bit."""
    from theatergen_tpu_torch.models.snapshot import MODULE_FIELDS

    bad = []
    for f in MODULE_FIELDS:
        ma, mb = getattr(a, f), getattr(b, f)
        if (ma is None) != (mb is None) or type(ma) is not type(mb):
            bad.append(f)
        elif ma is not None:
            sb = mb.state_dict()
            bad += [f"{f}.{k}" for k, v in ma.state_dict().items()
                    if sb[k].dtype != v.dtype or not torch.equal(sb[k], v)]
    return bad


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def checkpoint_path(records, default_dialogue_s: float) -> dict:
    """The checkpoint-loaded story turn.  A full-width SD1.5 checkpoint
    directory in the published names (``export.export_checkpoint_dir`` of
    ``init_bundle(sd15_config(), seed=0, with_ip=True, with_vision=True,
    with_controlnet=True)`` with a seeded sam-vit-base ``SamHF`` and
    ``LineartGenerator``: fp16 diffusers/transformers files and
    ``ip-adapter_sd15.bin``, fp32 ``sam.safetensors`` and
    ``lineart.safetensors``, no tokenizer assets) is written under build/;
    ``load_bundle`` of it must equal the fp16-rounded source cast to each
    module's dtype bit for bit; its snapshot must round-trip bit for bit
    (the cold starts timed, each ending in ``synchronize()``); its IP UNet
    must be within 5e-2·max|ref| of ``plain_path()``; SAM (1024² input)
    and the annotator (512²) are timed and launch none of the port's
    kernels.  Then dialogue_0 through the CLI with ``--weights DIR``, with
    ``--weights DIR --snapshot SNAP`` (saved) and with ``--snapshot SNAP``
    (loaded), each under turn_path's gates, SAM run once per kept
    character (the ``char.masks`` count), each character's mask area
    printed; the loaded run's images must equal the first run's bit for
    bit.  The directory is deleted at the end.  ``default_dialogue_s``:
    the random-weight dialogue's seconds in this run, printed beside."""
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "chip_smoke_checkpoint")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        return _checkpoint_phase(root, records, default_dialogue_s)
    finally:
        # up to ~12 GB of files: never left behind by a gate that fails
        shutil.rmtree(root, ignore_errors=True)


def _checkpoint_phase(root: str, records, default_dialogue_s: float
                      ) -> dict:
    """The body of :func:`checkpoint_path`, its files under ``root``."""
    from theatergen_tpu_torch.models import export, snapshot, weights

    ckpt = os.path.join(root, "weights")
    snap_dir = os.path.join(root, "snapshot")
    cli_snap = os.path.join(root, "cli_snapshot")
    free = shutil.disk_usage(root).free
    log(f"  disk free under build/: {free / 2 ** 30:.1f} GiB")
    cfg = sd15_config()
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(CKPT_SEED)
    src = init_bundle(cfg, seed=0, device="cuda", with_ip=True,
                      with_vision=True, with_controlnet=True)
    src.sam = build_sam(cfg, "cuda", gen, hf_cfg=SamHFConfig())
    src.lineart = build_lineart("cuda", gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sizes = export.export_checkpoint_dir(src, ckpt)
    write_s = time.perf_counter() - t0
    log(f"  checkpoint directory written: {sum(sizes.values())} bytes in "
        f"{write_s:.3f} s ({json.dumps(sizes)})")

    t0 = time.perf_counter()
    loaded = weights.load_bundle(cfg, ckpt)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    bad, n = loaded_mismatches(src, loaded)
    log(f"  load_bundle cold start: {load_s:.3f} s; {n} elements against "
        f"the fp16-rounded source: {'bit for bit' if not bad else bad[:5]}")
    if bad:
        raise SystemExit(f"load_bundle: {len(bad)} entries differ from the "
                         f"source, {bad[:5]}")
    del src
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    snapshot.save_bundle_snapshot(loaded, snap_dir)
    save_s = time.perf_counter() - t0
    snap_bytes = dir_bytes(snap_dir)
    t0 = time.perf_counter()
    snapped = snapshot.load_bundle_snapshot(cfg, snap_dir)
    torch.cuda.synchronize()
    snap_load_s = time.perf_counter() - t0
    bad = snapshot_mismatches(loaded, snapped)
    log(f"  snapshot: saved in {save_s:.3f} s, {snap_bytes} bytes; "
        f"load_bundle_snapshot cold start {snap_load_s:.3f} s; round trip "
        f"{'bit for bit' if not bad else bad[:5]}")
    if bad:
        raise SystemExit(f"snapshot round trip: {bad[:5]} differ")
    del snapped
    shutil.rmtree(snap_dir)
    gc.collect()
    torch.cuda.empty_cache()

    rel, _ = unet_reference_phase(loaded, 5e-2, loaded.unet_ip,
                                  ip_scale=torch.tensor(0.4, device="cuda"))
    image = ip_image()
    size = sam_lib.sam_input_size(loaded.sam)
    img_s = geometry.resize_bilinear(image[0].permute(2, 0, 1), size,
                                     size).permute(1, 2, 0)
    box = torch.tensor([0.1, 0.2, 0.6, 0.9], device="cuda")

    def segment():
        return sam_lib.segment_with_box(loaded.sam, img_s, box,
                                    out_sizes=(64, 512))

    reset_counts()
    with torch.no_grad():
        (m_lat, m_pix), conf = segment()
        lines = loaded.lineart(image)
    torch.cuda.synchronize()
    got = read_counts()
    ok = (not any(got.values()) and tuple(m_lat.shape) == (64, 64)
          and tuple(m_pix.shape) == (512, 512)
          and bool(((m_pix == 0) | (m_pix == 1)).all())
          and tuple(lines.shape) == (1, 512, 512, 3)
          and bool(torch.isfinite(lines).all())
          and 0.0 <= float(lines.min()) and float(lines.max()) <= 1.0)
    with torch.no_grad():
        sam_ms = time_ms(segment, 5, 1)
        lineart_ms = time_ms(lambda: loaded.lineart(image), 10, 2)
        det = [loaded.lineart(image) for _ in range(2)]
        # the annotator on cuDNN's default algorithms, for comparison
        with mock.patch.object(lineart_ops, "_deterministic_convolutions",
                               contextlib.nullcontext):
            dflt = [loaded.lineart(image) for _ in range(2)]
            lineart_default_ms = time_ms(lambda: loaded.lineart(image), 10,
                                         2)
    det_equal = torch.equal(det[0], det[1])
    default_diff = float((dflt[0] - dflt[1]).abs().max())
    log(f"  SAM ({size}² input, fp32): {sam_ms:.3f} ms a character, mask "
        f"area {float(m_pix.mean()):.4f}, IoU score {float(conf):.4f}; "
        f"annotator (512², fp32): {lineart_ms:.3f} ms a hint, two calls "
        f"{'equal' if det_equal else 'DIFFER'}; on cuDNN's default "
        f"algorithms {lineart_default_ms:.3f} ms, two calls {default_diff} "
        f"apart; launches of the port's kernels {got}  "
        f"{'ok' if ok and det_equal else 'FAIL'}")
    if not ok:
        raise SystemExit("SAM or the annotator: bad output, or they "
                         "launched the port's kernels")
    if not det_equal:
        raise SystemExit("the annotator gave other bits on a second "
                         "identical call")
    del loaded, m_lat, m_pix, lines, det, dflt
    gc.collect()
    torch.cuda.empty_cache()

    runs, images = {}, {}
    for label, flags in (("weights", ["--weights", ckpt]),
                         ("snapshot_save", ["--weights", ckpt, "--snapshot",
                                            cli_snap]),
                         ("snapshot_load", ["--snapshot", cli_snap])):
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[main path] dialogue_0 through the CLI with {' '.join(flags)}")
        areas, real_segment = [], sam_lib.segment_with_box

        def counted_segment(*a, **k):
            res = real_segment(*a, **k)
            areas.append(torch.stack([m.float().mean() for m in res[0]]))
            return res

        before, images[label] = sam_lib.segments, []
        sam_lib.segment_with_box = counted_segment
        try:
            runs[label] = turn_path(records, f"ckpt_{label}", flags,
                                    images=images[label])
        finally:
            sam_lib.segment_with_box = real_segment
        segments = sam_lib.segments - before
        masks = runs[label]["phase_summary"]["char.masks"]["count"]
        runs[label].update(sam_segments=segments, mask_areas=[
            [round(float(x), 4) for x in a] for a in areas])
        log(f"  SAM ran {segments} times, char.masks {masks}; mask areas "
            f"(latent, pixel) per character {runs[label]['mask_areas']}")
        if segments != masks:
            raise SystemExit(f"{label}: SAM ran {segments} times for {masks} "
                             f"characters")
    same = {label: all(np.array_equal(a, b) for t, u in zip(
        images[label], images["weights"]) for a, b in zip(t, u))
        and len(images[label]) == len(images["weights"])
        for label in ("snapshot_save", "snapshot_load")}
    log(f"  images against the --weights run, bit for bit: {same}; "
        f"dialogue seconds "
        f"{ {k: r['dialogue_seconds'] for k, r in runs.items()} }, the "
        f"random-weight default turn's {default_dialogue_s}")
    if not all(same.values()):
        raise SystemExit(f"the --snapshot runs' images differ: {same}")
    phase_s = time.perf_counter() - t_phase
    log(f"  {CKPT}: {phase_s:.1f} s for the phase")
    return dict(checkpoint_bytes=sizes, checkpoint_write_s=write_s,
                load_bundle_s=load_s, snapshot_bytes=snap_bytes,
                snapshot_save_s=save_s, load_bundle_snapshot_s=snap_load_s,
                ip_unet_kernels_vs_plain_rel=rel, sam_ms=sam_ms,
                lineart_ms=lineart_ms, lineart_default_ms=lineart_default_ms,
                lineart_default_rerun_diff=default_diff, runs=runs,
                images_equal=same,
                phase_seconds=phase_s)


def request_ab(model: str, one_request) -> dict:
    """Seconds per request with the GroupNorm switch at "0" and "1" in
    turns: AB_PAIRS[model] pairs in ABBA order (0 1, 1 0, 0 1, ...), so a
    drift of the shared host's pace falls on both sides; ``one_request(p)``
    runs pair p's request under the current switch.  Reports the paired
    differences "1" - "0", their mean, standard deviation and standard
    error."""
    pairs, prev_mode = AB_PAIRS[model], gn.FUSED_MODE
    secs = {"0": [], "1": []}
    for p in range(pairs):
        for mode in ("0", "1") if p % 2 == 0 else ("1", "0"):
            gn.FUSED_MODE = mode
            secs[mode].append(one_request(p))
    gn.FUSED_MODE = prev_mode
    diffs = [b - a for a, b in zip(secs["0"], secs["1"])]
    mean = sum(diffs) / pairs
    sd_ = (sum((d - mean) ** 2 for d in diffs) / (pairs - 1)) ** 0.5
    out = dict(seconds=secs, diffs=diffs, mean_diff=mean, sd_diff=sd_,
               se_diff=sd_ / pairs ** 0.5,
               mean_seconds={m: sum(v) / pairs for m, v in secs.items()})
    log(f"  {model} request A/B over {pairs} pairs: {json.dumps(out)}")
    return out


def host_ab(bundle, **kw) -> dict:
    """Wall ms per IP UNet evaluation (10 back to back, CUDA events: the
    loop's pace, which the host sets) and per call of one bf16
    GroupNorm+SiLU layer at the 8²×1280 shape (200 back to back: its host
    cost, the kernel being ~3 µs), switch "0" and "1" in turns."""
    x, t, ctx, _ = unet_inputs(bundle, 4, 501, 81)
    norm = GroupNorm(32, 1280, act="silu", fp32=False).to(
        "cuda", torch.bfloat16)
    xs = torch.randn(2, 1280, 8, 8, device="cuda", dtype=torch.bfloat16)
    prev_mode = gn.FUSED_MODE
    evals, layer = collections.defaultdict(list), collections.defaultdict(
        list)
    with torch.no_grad():
        for mode in ("0", "1", "1", "0", "0", "1"):
            gn.FUSED_MODE = mode
            evals[mode].append(time_ms(
                lambda: bundle.unet_ip(x, t, ctx, **kw), 10, 2))
            layer[mode].append(time_ms(lambda: norm(xs), 200, 10))
    gn.FUSED_MODE = prev_mode
    log(f"  wall ms per IP UNet evaluation by switch {dict(evals)}; per "
        f"norm-layer call {dict(layer)}")
    return dict(unet_eval_wall_ms=dict(evals), norm_layer_call_ms=dict(layer))


def gn_kernel_kind(name: str):
    """The GroupNorm kernel a profiler name belongs to: this port's
    ("group_norm_ours"), PyTorch's F.group_norm ("group_norm_library"),
    or neither (None)."""
    low = name.lower()
    if "group_norm_kernel<" in name and "at::native" not in name:
        return "group_norm_ours"
    if "at::native" in name and any(k in low for k in (
            "groupnorm", "group_norm", "rowwisemoments",
            "computefusedparams")):
        return "group_norm_library"
    return None


def gn_ab_profile(bundle, unet, **kw) -> dict:
    """Device time of one evaluation of ``unet`` (batch 2) with the switch
    at "0" and at "1", in turns: in all, in GroupNorm kernels (this port's
    and PyTorch's, apart and together), and in SiLU kernels (the separate
    activation the kernel folds in), by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile as prof
    prev_mode = gn.FUSED_MODE
    x, t, ctx, cond = unet_inputs(bundle, 3, 501,
                                  77 + unet.cfg.ip_num_tokens)
    out = {}
    for mode in ("0", "1", "1", "0"):
        gn.FUSED_MODE = mode
        with torch.no_grad():
            unet(x, t, ctx, **cond, **kw)
            torch.cuda.synchronize()
            with prof(activities=[ProfilerActivity.CUDA]) as p:
                unet(x, t, ctx, **cond, **kw)
                torch.cuda.synchronize()
        parts = collections.Counter()
        for e in p.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if e.key.startswith("aten::") or us <= 0:
                continue
            parts["total"] += us / 1e3
            norm = gn_kernel_kind(e.key)
            if norm:
                parts["group_norm"] += us / 1e3
                parts[norm] += us / 1e3
            elif "silu" in e.key.lower():
                parts["silu"] += us / 1e3
        out.setdefault(mode, []).append(dict(parts))
        log(f"  UNet evaluation, switch {mode}: device ms "
            f"{json.dumps(dict(parts))}")
    gn.FUSED_MODE = prev_mode
    return out


def profile(bundle, encode) -> None:
    """Device time by kernel name over one UNet evaluation (batch 2), and
    the wall time of the request's parts: one UNet evaluation (CUDA events
    around 5 back to back, the loop's pace), prompt encoding and VAE
    decode."""
    from torch.profiler import ProfilerActivity, profile as prof
    cfg = bundle.cfg
    x, t, ctx, cond = unet_inputs(bundle, 2, 501)
    with torch.no_grad():
        bundle.unet(x, t, ctx, **cond)
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            bundle.unet(x, t, ctx, **cond)
            torch.cuda.synchronize()
        log(p.key_averages().table(sort_by="cuda_time_total", row_limit=25))
        lat = x[:1].permute(0, 2, 3, 1).contiguous()
        parts = {
            "unet_eval": time_ms(lambda: bundle.unet(x, t, ctx, **cond), 5, 1),
            "encode_prompts": time_ms(lambda: encode(bundle, PROMPTS[0]), 5, 1),
            "vae_decode": time_ms(lambda: sd.decode_with(
                bundle.vae, cfg.vae.scaling_factor, lat), 3, 1)}
    log(f"  wall ms per part: {json.dumps(parts)}")


# ---------------------------------------------------------------------------
# latent guidance: gradients through the kernels, the energy's gradient, and
# the guided requests
# ---------------------------------------------------------------------------


def _grad_inputs(gen, name: str, shape) -> tuple:
    """(wrapper call, plain call, bf16 inputs, which need a gradient) of a
    kernel at a GRAD_SHAPES shape; the activation needs one, the weights
    not (the guided UNet's modules need none)."""
    if name == "flash_attention":
        qkv = [randn(gen, *shape) for _ in range(3)]
        return (fa.flash_attention, fa.flash_attention_plain, qkv,
                [True] * 3)
    if name == "ff_geglu":
        m, d, k = shape
        ins = [randn(gen, m, d), randn(gen, 2 * k, d, scale=d ** -0.5),
               randn(gen, 2 * k, scale=0.1), randn(gen, d, k, scale=k ** -0.5)]
        return gg.ff_matmul, gg.ff_matmul_plain, ins, [True] + [False] * 3
    if name == "geglu_matmul":
        m, k, n = shape
        ins = [randn(gen, m, 2 * k), randn(gen, n, k, scale=k ** -0.5)]
        return gg.geglu_matmul, gg.geglu_matmul_plain, ins, [True, False]
    b, c, hw, act = shape
    side = int(hw ** 0.5)
    ins = [randn(gen, b, c, side, side),
           (1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)).to(
               torch.bfloat16), randn(gen, c, scale=0.1)]
    return (lambda *a: gn.fused_group_norm(*a, act=act),
            lambda *a: gn.fused_group_norm_plain(*a, act=act), ins,
            [True, False, False])


def grad_gate_phase(gen, records) -> list:
    """Gate (a): each kernel's autograd Function at the guided UNets'
    batch-1 shapes (GRAD_SHAPES).  The forward launches one kernel and
    stays within TOL of the plain version (fp32 copies of the inputs); the
    backward under one upstream gradient launches none and gives the
    plain version's gradients on the same bf16 inputs bit for bit (the
    backward is that version, recomputed).  Times: the kernel forward plus
    the recomputing backward, against the plain forward plus its backward
    (CUDA events, 5 calls each).  Rows go to each kernel's record under
    ``grad_gates``."""
    by_name = {r["name"]: r for r in records}
    rows = []
    for name, model, shape in GRAD_SHAPES:
        wrapper, plain, ins, needs = _grad_inputs(gen, name, shape)
        mod, attr = COUNTERS[name]

        def fwd_bwd(fn):
            leaves = [x.detach().requires_grad_(n) for x, n in zip(ins, needs)]
            out = fn(*leaves)
            return out, torch.autograd.grad(
                out, [x for x, n in zip(leaves, needs) if n], grad_out)

        n0 = getattr(mod, attr)
        leaves = [x.detach().requires_grad_(n) for x, n in zip(ins, needs)]
        out = wrapper(*leaves)
        torch.cuda.synchronize()
        fwd_launches = getattr(mod, attr) - n0
        ref32 = plain(*[x.float() for x in ins])
        err = (out.float() - ref32).abs().max().item()
        check(err, ref32.abs().max().item(),
              f"{name} forward under autograd {model} {list(shape)}")
        grad_out = randn(gen, *out.shape)
        got = torch.autograd.grad(
            out, [x for x, n in zip(leaves, needs) if n], grad_out)
        torch.cuda.synchronize()
        bwd_launches = getattr(mod, attr) - n0 - fwd_launches
        _, want = fwd_bwd(plain)
        equal = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
        nonzero = all(bool(a.abs().max() > 0) for a in got)
        row = dict(model=model, shape=list(shape), fwd_err=err,
                   fwd_launches=fwd_launches, bwd_launches=bwd_launches,
                   grads_bit_equal=equal,
                   kernel_fwd_bwd_ms=time_ms(lambda: fwd_bwd(wrapper), 5, 1),
                   plain_fwd_bwd_ms=time_ms(lambda: fwd_bwd(plain), 5, 1),
                   kernel_fwd_ms=time_ms(lambda: wrapper(*[
                       x.detach().requires_grad_(n)
                       for x, n in zip(ins, needs)]), 5, 1))
        rows.append(row)
        ok = (fwd_launches == 1 and bwd_launches == 0 and equal and nonzero)
        log(f"  gradient gate {name} {model} {list(shape)}: forward "
            f"{fwd_launches} launch, backward {bwd_launches}; gradients "
            f"equal to the plain version's bit for bit: {equal}; kernel "
            f"forward + plain backward {row['kernel_fwd_bwd_ms']:.5f} ms "
            f"(forward {row['kernel_fwd_ms']:.5f}), plain forward + "
            f"backward {row['plain_fwd_bwd_ms']:.5f}  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name}: the gradient gate failed at "
                             f"{list(shape)}")
        by_name[name].setdefault("grad_gates", []).append(row)
        del ins, leaves, out, got, want, ref32, grad_out
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def guidance_log():
    """Record every guidance update of the block: a list of (step,
    iterations), appended by a wrapper around
    ``pipelines.guidance.guidance_update`` (the runners call it through
    the module)."""
    calls, real = [], guidance_lib.guidance_update

    def logged(*a, **kw):
        out = real(*a, **kw)
        calls.append((a[4] if len(a) > 4 else kw["step_index"], out[2]))
        return out

    guidance_lib.guidance_update = logged
    try:
        yield calls
    finally:
        guidance_lib.guidance_update = real


def passes_of(calls) -> list:
    """Per guided pass (a runner's call), its iterations per step: a pass
    starts at step 0."""
    out = []
    for step, n in calls:
        if step == 0 or not out:
            out.append([])
        out[-1].append(n)
    return out


def guided_iter_want(model: str) -> dict:
    """Launches of one guidance iteration of a character or final path:
    one full cond-only evaluation of its IP UNet (no ControlNet)."""
    ucfg, side, _ = path_cfg(model)
    return counts(**eval_launches(ucfg, side, 1))


def guided_inputs(n_obj: int, cfg, device="cuda", refs=None):
    """Seeded GuidanceInputs of ``n_obj`` layout boxes with two tokens
    each (``max_objects`` slots, 8 token positions)."""
    k, p = cfg.pipeline.max_objects, 8
    boxes = torch.zeros(k, 4)
    pos = torch.zeros(k, p, dtype=torch.long)
    valid = torch.zeros(k, p, dtype=torch.bool)
    for i in range(n_obj):
        boxes[i] = torch.tensor([0.05 + 0.45 * i, 0.15, 0.5 + 0.45 * i, 0.95])
        pos[i, :2] = torch.tensor([4 + 3 * i, 5 + 3 * i])
        valid[i, :2] = True
    gin = guidance_lib.GuidanceInputs(
        boxes, pos, valid, torch.arange(k) < n_obj, pos[:, 1].clone(), refs)
    return gin.to(device)


def energy_grad_phase() -> dict:
    """Gate (b): the guidance energy's latent gradient through one
    full-size SD1.5 IP UNet (batch 1, cond-only, capture at the guidance
    keys, two objects with step-aggregated reference maps) with the
    kernels against ``plain_path()``: max|diff|/max|ref| within
    ENERGY_GRAD_BOUND, cosine at least ENERGY_COS_BOUND; against the same
    UNet in fp32 (plain), the kernels' relative L2 distance within
    ENERGY_FP32_RATIO times the bf16 plain path's and the cosine at least
    ENERGY_FP32_COS; a nonzero fp32 gradient, and the launches of one
    cond-only evaluation in the forward (counters 0 just before, read
    after the backward: the backward launches none).  Then the times: one guidance iteration (energy
    forward with the kernels plus the recomputing backward) against one
    unguided batch-1 evaluation (no_grad), the forward alone, and the
    share of the backward in each kernel's plain recompute (CUDA events
    around each ``recompute.plain_vjp`` call)."""
    cfg = sd15_config()
    gcfg = cfg.guidance
    bundle = init_bundle(cfg, seed=0, device="cuda", with_ip=True)
    unet = bundle.unet_ip
    g = torch.Generator(device="cuda").manual_seed(41)
    side = cfg.pipeline.latent_height
    lat = torch.randn(1, 4, side, side, device="cuda", generator=g)
    ctx = torch.randn(1, 77 + 4, cfg.unet.cross_attention_dim,
                      device="cuda", generator=g)
    t = torch.tensor(801, device="cuda")
    ip_scale = torch.tensor(0.4, device="cuda")
    with torch.no_grad():
        _, cap = unet(lat, t.expand(1), ctx, capture_keys=gcfg.attn_keys,
                      ip_scale=ip_scale)
    refs = tuple(torch.rand((cfg.pipeline.max_objects,)
                            + tuple(cap[tuple(k)].shape[1:3]),
                            device="cuda", generator=g)
                 for k in gcfg.attn_keys)
    gin = guided_inputs(2, cfg, refs=refs)
    energy = guidance_lib.unet_energy_fn(unet, cfg, ip_scale=ip_scale)

    def grad(energy=energy):
        leaf = lat.clone().requires_grad_(True)
        e = energy(leaf, t, ctx, gin) * gcfg.loss_scale
        return e, torch.autograd.grad(e, leaf)[0]

    reset_counts()
    e_k, g_k = grad()
    torch.cuda.synchronize()
    got = read_counts()
    want = guided_iter_want(CHAR)
    with plain_path():
        e_p, g_p = grad()
        e_32, g_32 = grad(guidance_lib.unet_energy_fn(
            copy.deepcopy(unet).float(), cfg, ip_scale=ip_scale))
        torch.cuda.synchronize()
    plain_launches = read_counts()

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()

    def cosine(a, b):
        return F.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()

    rel = ((g_k - g_p).abs().max() / g_p.abs().max()).item()
    cos = cosine(g_k, g_p)
    l2_k, l2_p = rel_l2(g_k, g_32), rel_l2(g_p, g_32)
    cos_32 = cosine(g_k, g_32)
    norm = g_32.norm().item()
    ok = (got == want and plain_launches == got and rel <= ENERGY_GRAD_BOUND
          and cos >= ENERGY_COS_BOUND and l2_k <= ENERGY_FP32_RATIO * l2_p
          and cos_32 >= ENERGY_FP32_COS and norm > 0
          and g_k.dtype == torch.float32
          and bool(torch.isfinite(g_k).all()))
    log(f"  energy {e_k.item():.5f} (plain path {e_p.item():.5f}, fp32 "
        f"{e_32.item():.5f}); latent gradient, kernels vs plain path: "
        f"max|diff|/max|ref| {rel:.3e} (bound {ENERGY_GRAD_BOUND}), cosine "
        f"{cos:.6f} (bound {ENERGY_COS_BOUND}); against the fp32 UNet: "
        f"relative L2 {l2_k:.4e} (plain path {l2_p:.4e}, bound "
        f"{ENERGY_FP32_RATIO}x), cosine {cos_32:.6f} (bound "
        f"{ENERGY_FP32_COS}); norm {g_k.norm().item():.4e} (fp32 "
        f"{norm:.4e}), dtype {g_k.dtype}; launches of the forward and "
        f"backward {got}, want one cond-only evaluation's {want}, none "
        f"under plain_path  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the energy's gradient through the kernels "
                         "disagrees with the plain path's")
    del g_32
    torch.cuda.empty_cache()

    def unguided():
        with torch.no_grad():
            return unet(lat, t.expand(1), ctx, ip_scale=ip_scale)

    def forward():
        leaf = lat.clone().requires_grad_(True)
        return energy(leaf, t, ctx, gin)

    def wall_ms(fn, n=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    times = dict(iteration_ms=time_ms(grad, 5, 1),
                 iteration_wall_ms=wall_ms(grad),
                 forward_ms=time_ms(forward, 5, 1),
                 unguided_eval_ms=time_ms(unguided, 5, 1),
                 unguided_eval_wall_ms=wall_ms(unguided),
                 iteration_device_ms=device_ms(grad),
                 unguided_eval_device_ms=device_ms(unguided))
    times["backward_ms"] = times["iteration_ms"] - times["forward_ms"]
    spans, real = [], recompute.plain_vjp

    def timed(plain, *a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(plain, *a, **kw)
        end.record()
        spans.append((plain.__name__, start, end))
        return out

    recompute.plain_vjp = timed
    try:
        grad()
        torch.cuda.synchronize()
    finally:
        recompute.plain_vjp = real
    recompute_ms = collections.defaultdict(float)
    calls = collections.Counter()
    for name, start, end in spans:
        recompute_ms[name] += start.elapsed_time(end)
        calls[name] += 1
    share = {k: v / times["backward_ms"] for k, v in recompute_ms.items()}
    log(f"  one guidance iteration {times['iteration_ms']:.3f} ms "
        f"(wall {times['iteration_wall_ms']:.3f}, device "
        f"{times['iteration_device_ms']:.3f}): forward "
        f"{times['forward_ms']:.3f}, backward {times['backward_ms']:.3f}; "
        f"one unguided batch-1 evaluation {times['unguided_eval_ms']:.3f} "
        f"ms (wall {times['unguided_eval_wall_ms']:.3f}, device "
        f"{times['unguided_eval_device_ms']:.3f})")
    log(f"  plain recomputes in the backward: calls {dict(calls)}, ms "
        f"{json.dumps(recompute_ms)}, share of the backward "
        f"{json.dumps(share)}")
    out = dict(energy=e_k.item(), energy_plain=e_p.item(), grad_rel=rel,
               grad_cos=cos, grad_rel_l2_fp32=l2_k,
               plain_rel_l2_fp32=l2_p, grad_cos_fp32=cos_32,
               grad_norm=g_k.norm().item(), launches=got, times=times,
               recompute_ms=dict(recompute_ms), recompute_calls=dict(calls),
               recompute_share=share)
    return out


def xl_guided_request(bundle, image, records) -> dict:
    """One guided SDXL character request at 1024 px through the XL IP UNet
    (XL_GUIDED_STEPS Euler-Ancestral steps, all guided, one layout box),
    and the unguided request from the same latents and noise: wall time,
    iterations per step, launches equal to the unguided request's plus one
    cond-only XL IP UNet evaluation per iteration, guided images finite
    and other than the unguided ones."""
    cfg = bundle.cfg
    side = cfg.pipeline.latent_height
    text, pooled = sdxl.encode_prompts_xl(bundle, PROMPTS[0])
    ctx = character.ip_context(bundle, text,
                               character.encode_ip_image(bundle, image))
    extra = dict(pooled_text=pooled, time_ids=sdxl.default_time_ids(
        cfg.pipeline.height, cfg.pipeline.width, 2, "cuda"))
    g = torch.Generator(device="cuda").manual_seed(300)
    lat = torch.randn(1, side, side, 4, device="cuda", generator=g)
    lat = lat * character.make_character_pipeline(
        bundle, XL_GUIDED_STEPS)[1].init_noise_sigma
    gin = guided_inputs(1, cfg)
    base = path_want(XL_CHAR, XL_GUIDED_STEPS, sampler="euler_ancestral")
    per_iter = guided_iter_want(XL_CHAR)
    out, images = {}, {}
    for guided in (True, False):
        run, _ = character.make_character_pipeline(
            bundle, XL_GUIDED_STEPS, use_ip=True, guided=guided,
            capture_ref_attn=True)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with guidance_log() as calls:
            t0 = time.perf_counter()
            res = run(lat, ctx, 0.4, 5,
                      torch.Generator(device="cuda").manual_seed(301),
                      extra_cond=extra, gin=gin if guided else None)
            img = sd.decode_with(bundle.vae, cfg.vae.scaling_factor,
                                 res.latents)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        got = read_counts()
        iters = [n for _, n in calls]
        want = {k: base[k] + sum(iters) * per_iter[k] for k in COUNTERS}
        add_launches(records, XL_GUIDED if guided else XL_CHAR, got)
        images[guided] = img
        finite = bool(torch.isfinite(img).all())
        label = "guided" if guided else "unguided"
        log(f"  XL character request, {label}, {XL_GUIDED_STEPS} steps: "
            f"{seconds:.3f} s  iterations per step {iters}  launches {got}"
            f"  want {want}  peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB  image "
            f"finite {finite}")
        if got != want or not finite:
            raise SystemExit(f"the {label} XL character request failed")
        out[label] = dict(seconds=seconds, iterations=iters, launches=got,
                          peak_bytes=torch.cuda.max_memory_allocated())
    diff = (images[True] - images[False]).abs().max().item()
    log(f"  guided vs unguided XL image: max|diff| {diff:.4f}  "
        f"{'ok' if diff > 1e-3 else 'FAIL'}")
    if diff <= 1e-3:
        raise SystemExit("the guided XL request gave the unguided image")
    out["image_max_diff"] = diff
    return out


def guided_path(records, unguided_images) -> dict:
    """Latent guidance on the card: gate (b) (energy_grad_phase), then
    dialogue_0 through the CLI with ``--guidance`` (turn_path with the
    guidance iterations in each turn's launches), its images against the
    unguided dialogue's (the same seeds)."""
    out = dict(energy_grad=energy_grad_phase())
    gc.collect()
    torch.cuda.empty_cache()
    images = []
    out["dialogue"] = turn_path(records, "guided", ["--guidance"],
                                images=images, guided=True)
    diffs = [float(np.abs(g[0] - u[0]).max())
             for g, u in zip(images, unguided_images)]
    log(f"  guided vs unguided dialogue_0, max|diff| per turn's image: "
        f"{diffs}  {'ok' if all(d > 1e-3 for d in diffs) else 'FAIL'}")
    if len(diffs) != 4 or not all(d > 1e-3 for d in diffs):
        raise SystemExit("a guided turn gave the unguided image")
    out["image_max_diff"] = diffs
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel for one UNet "
                         "evaluation of each model, and run the GroupNorm "
                         "A/B")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if gn.FUSED_MODE not in ("0", "1"):
        print(f"chip_smoke: THEATERGEN_FUSED_GN={gn.FUSED_MODE!r}; the launch "
              f"counts are set for \"0\" or \"1\"", file=sys.stderr)
        return 1
    if qz.FUSED_MODE != "0":
        print(f"chip_smoke: THEATERGEN_FUSED_INT8={qz.FUSED_MODE!r}; the "
              f"script sets the switch itself for the W8A8 requests and "
              f"keeps the port's default \"0\" elsewhere", file=sys.stderr)
        return 1
    preset = sorted(k for k in fa.SWITCHES if k in os.environ)
    if preset:
        print(f"chip_smoke: {preset} set; the script sets the flash switches "
              f"itself, request by request, and counts each route's "
              f"launches under the defaults elsewhere", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        print(f"chip_smoke: nvidia-smi failed: {smi.stderr}", file=sys.stderr)
        return 1
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)}  torch {torch.__version__} "
        f"cuda {torch.version.cuda}  python {sys.version.split()[0]}  "
        f"THEATERGEN_FUSED_GN {gn.FUSED_MODE}  THEATERGEN_FUSED_INT8 "
        f"{qz.FUSED_MODE}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    _build.build()
    log(f"[build] {time.perf_counter() - t_start:.2f} s for "
        f"{_build.kernel_names()} into {_build.BUILD_DIR}")
    for name, info in sorted(_build.build_log.items()):
        log(f"  {name}.cu: nvcc {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line) \
                    or "spill" in line:
                log(f"    {line.strip()}")

    log("[launch counts] derived from the routing functions per "
        "evaluation kind")
    derivation_check()
    gen = torch.Generator(device="cuda").manual_seed(0)
    log("[check+time] kernels vs plain versions at both models' shapes")
    records = [
        _record("flash_attention", "csrc/flash_attention.cu",
                "theatergen_tpu/ops/flash_attention.py:283",
                "flash_attention_packed (_flat_call)",
                flash_phase(gen, FLASH_SHAPES, "packed")),
        _record("flash_attention_long", "csrc/flash_attention.cu",
                "theatergen_tpu/ops/flash_attention.py:435",
                "_flash_attention_flat_online (_flat_online_call)",
                flash_phase(gen, FLASH_LONG_SHAPES, "flat_online")),
        _record("flash_attention_bshd", "csrc/flash_attention.cu",
                "theatergen_tpu/ops/flash_attention.py:561",
                "_flash_attention_bshd",
                flash_phase(gen, FLASH_BSHD_SHAPES, "bshd")),
        _record("flash_attention_copy", "csrc/flash_attention.cu",
                "theatergen_tpu/ops/flash_attention.py:633",
                "flash_attention (_flash_attention_impl)",
                flash_phase(gen, FLASH_COPY_SHAPES, "copy")),
        ff_phase(gen), geglu_phase(gen), gn_phase(gen), qmm_phase(gen)]
    sp_shards = sp_shards_phase(gen)
    host_us = host_us_phase(gen)
    torch.cuda.synchronize()
    log("[gradients] each kernel's autograd Function at the guided UNets' "
        "batch-1 shapes: forward against the plain version, backward equal "
        "to the plain version's gradients bit for bit")
    grad_gates = grad_gate_phase(gen, records)

    log(f"[main path] SD1.5 Text2Img, 512 px, {SD15_STEPS} DDIM steps, "
        f"CFG 7.5, bf16")
    paths = {}
    paths[SD15], float_eps = sd15_path(records, args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[main path] W8A8 SD1.5 Text2Img, 512 px, {SD15_STEPS} DDIM steps, "
        f"CFG 7.5, bf16 activations, int8 weights at the {QMM_PER_EVAL} "
        f"quantized linears")
    paths[W8A8] = w8a8_path(records, args.profile, float_eps, paths[SD15])
    del float_eps
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[main path] SDXL Text2ImgXL, 1024 px, {SDXL_STEPS} Euler-Ancestral "
        f"steps, CFG 7.5, bf16 UNet, fp32 text towers")
    paths[SDXL] = sdxl_path(records, args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[main path] the SDXL turn's models: the T2I-Adapter, the XL IP "
        f"UNet with micro-conditioning and level residuals, Text2ImgXL with "
        f"a hint, 1024 px, {SDXL_STEPS} Euler-Ancestral steps, CFG 7.5")
    paths[XL_CHAR] = xl_path(records)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[main path] IP-Adapter character pass, SD1.5 512 px, "
        f"{SD15_STEPS} DDIM steps, CFG 7.5, bf16 UNet, fp32 ViT-H/14 tower")
    paths[CHAR], ip_eps = character_path(records, args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[main path] W8A8 IP-Adapter character pass, SD1.5 512 px, "
        f"{SD15_STEPS} DDIM steps, THEATERGEN_FUSED_INT8=1")
    paths[CHAR_W8A8] = w8a8_character_path(records, ip_eps)
    del ip_eps
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[main path] the back half of a turn: masks, composition, collage, "
        f"lineart and the ControlNet final pass, SD1.5 at 512 and 768 px, "
        f"{SD15_STEPS} DDIM steps, CFG 7.5, frozen_steps {FROZEN_STEPS}, "
        f"ip_scale {IP_SCALE_FINAL}")
    paths.update(final_paths(records))
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[main path] a story dialogue through the CLI: dialogue_0 of "
        f"data/sample/story.json, 4 turns, SD1.5 512 px, {SD15_STEPS} DDIM "
        f"steps, CFG 7.5, frozen_step_ratio 0.5")
    unguided_images = []
    paths[TURN] = turn_path(records, images=unguided_images)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[main path] latent guidance: the energy's gradient through the "
        f"SD1.5 IP UNet against plain_path(), then dialogue_0 through the "
        f"CLI with --guidance, 512 px, {SD15_STEPS} DDIM steps, guidance in "
        f"the first 25 steps of every character and final pass")
    paths[GUIDED_TURN] = guided_path(records, unguided_images)
    del unguided_images
    for label, flags, steps, knobs in TURN_KNOBS:
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[main path] dialogue_0 through the CLI with {' '.join(flags)}, "
            f"{steps} steps")
        paths[f"{TURN}_{label}"] = turn_path(records, label, flags, steps,
                                             knobs)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[main path] the SDXL story dialogue through the CLI: dialogue_0 "
        f"with --sd_version xl --box_canvas {XL_BOX_CANVAS}, 4 turns, 1024 "
        f"px, {SDXL_STEPS} Euler-Ancestral steps, CFG 7.5, the T2I-Adapter "
        f"on the lineart in the final pass")
    paths[XL_TURN] = turn_path(
        records, flags=["--sd_version", "xl", "--box_canvas",
                        str(XL_BOX_CANVAS)],
        steps=SDXL_STEPS, knobs=dict(sampler="euler_ancestral"), xl=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[main path] the checkpoint-loaded story turn: a synthetic SD1.5 "
        f"checkpoint directory in the published names (with sam-vit-base "
        f"and the lineart annotator), load_bundle, snapshots, and "
        f"dialogue_0 through the CLI with --weights and --snapshot, 512 px, "
        f"{SD15_STEPS} DDIM steps, SAM masks and the annotator's hint")
    paths[CKPT] = checkpoint_path(records, paths[TURN]["dialogue_seconds"])
    paths["sp_shards_equal"] = sp_shards
    paths["grad_gates"] = len(grad_gates)
    paths["wrapper_host_us_per_call"] = host_us
    log(f"[done] {time.perf_counter() - t_start:.1f} s after the build began")
    log(json.dumps({"main_path": paths, "card": card}))
    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
