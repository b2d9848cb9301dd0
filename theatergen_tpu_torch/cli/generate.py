"""CMIGBench generation driver, serial loop.

The port of ``theatergen_tpu/cli/generate.py`` without its wave mode.  It
keeps the reference CLI's flags, seed discipline, resume and output tree
(``generate.py:34-48,155-269``):

- output tree ``<base_save_dir>/<task>/run<k>/<dialogue>/turn n/img_<rep>.png``
  and ``so_<rep>_<i>.png`` per character (``generate.py:168,192,199``);
- a character DB per dialogue, ``<database_path_base>/<task>/<dialogue>/``
  (``generate.py:186-187``);
- resume by existence: a turn whose directory exists is skipped
  (``generate.py:193-194``);
- error quarantine: a turn that raises is printed, logged and skipped
  (``generate.py:250-259``);
- ``run_log.jsonl`` beside the tree: a ``turn`` event per turn, a
  ``quarantine`` event per failed turn, a ``dialogue`` event with the
  phase summary, and a ``summary`` event.

Seeds are a deterministic hash of (seed offset, dialogue index or frozen
seed, turn, repeat, regenerate pass), so any turn regenerates alike in
isolation.  The sampler knobs of the JAX package's CLI apply to the config
(:func:`apply_pipeline_overrides`): ``--cfg_cutoff``, ``--deepcache``,
``--cn_interval``, ``--scheduler``, ``--prediction_type`` and
``--zero_snr``; ``--profile`` writes a ``torch.profiler`` trace of the
first dialogue (host and device) to ``<save dir>/profile``.
``--guidance`` turns latent guidance on (``Theater(guided=True)``) unless
``--no_guidance`` is given too, as in the JAX CLI.
``--sd_version xl`` runs the SDXL turn (``sdxl_config()``, or
``tiny_xl_config()`` under ``--tiny``) with the T2I-Adapter in place of the
ControlNet, as the JAX CLI builds it.  ``--weights DIR`` loads the bundle
from a directory of published checkpoints (``models/weights.py::
load_bundle``: ``unet.safetensors``, ``vae.safetensors``,
``text_encoder.safetensors``, ``controlnet.safetensors``,
``image_encoder.safetensors``, ``ip-adapter_sd15.bin``,
``sam.safetensors``, ``lineart.safetensors``, tokenizer assets); ``--snapshot
DIR`` loads a bundle snapshot from DIR where one is there, and otherwise
builds or loads the bundle and saves it there.  Runs on the card unless
``--device`` names another device::

    python -m theatergen_tpu_torch.cli.generate --tiny --device cpu \\
        --dataset_path data/sample --max_dialogues 1 --num_steps 4 \\
        --deepcache 2 --cfg_cutoff 0.5 --cn_interval 2
    python -m theatergen_tpu_torch.cli.generate --sd_version xl \\
        --dataset_path data/sample --max_dialogues 1 --box_canvas 512
    python -m theatergen_tpu_torch.cli.generate --weights ckpt \\
        --snapshot ckpt_snap --dataset_path data/sample --max_dialogues 1
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import numpy as np

# flags of the JAX driver that raise here, and the ROADMAP §1 item that
# brings each
UNPORTED_FLAGS = {"dp_dialogues": 5, "mesh": 5, "batch_chars": 5}


def turn_seed(seed_offset: int, dialogue_base: int, turn_idx: int,
              repeat: int, regen: int = 0) -> int:
    """Deterministic per-(regenerate pass, dialogue, turn, repeat) seed; a
    regenerate pass sees fresh randomness (the reference advances
    seed_offset per pass, generate.py:157-160)."""
    return (seed_offset * 1_000_003 + regen * 7_919_997
            + dialogue_base * 10_007 + turn_idx * 101 + repeat) % (2**31 - 1)


def build_spec(turn_data: dict) -> dict:
    """CMIGBench turn dict → spec (``generate.py:205-226``)."""
    obj_ids, gen_boxes = [], []
    for bbox in turn_data.get("objects", []):
        gen_boxes.append((bbox[0], tuple(bbox[1])))
        obj_ids.append(bbox[2])
    return {
        "prompt": turn_data["caption"],
        "gen_boxes": gen_boxes,
        "bg_prompt": turn_data.get("background", ""),
        "extra_neg_prompt": turn_data.get("negative", ""),
        "obj_ids": obj_ids,
    }


def save_image(path: str, image: np.ndarray) -> None:
    from ..utils import png

    os.makedirs(os.path.dirname(path), exist_ok=True)
    png.write_png(path, png.to_uint8(image))


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="TheaterGen CMIGBench driver (PyTorch port)")
    ap.add_argument("--task", default="story", choices=["story", "editing"])
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--regenerate", type=int, default=1)
    ap.add_argument("--force_run_ind", type=int, default=0)
    ap.add_argument("--seed_offset", type=int, default=0)
    ap.add_argument("--sd_version", default="1.5", choices=["1.5", "xl"])
    ap.add_argument("--database_path_base", default="database")
    ap.add_argument("--base_save_dir", default="img_generations")
    ap.add_argument("--dataset_path", default="CMIGBench")
    ap.add_argument("--frozen_step_ratio", type=float, default=0.5)
    ap.add_argument("--freeze_dialogue_seed", type=int, default=None)
    ap.add_argument("--num_steps", type=int, default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny random-weight config (smoke runs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the bundle (default: the card)")
    ap.add_argument("--box_canvas", type=int, default=None,
                    help="authoring canvas of the dataset's pixel boxes "
                         "(CMIGBench: 512); defaults to the render size, "
                         "and to 512 with --tiny")
    ap.add_argument("--max_dialogues", type=int, default=None)
    ap.add_argument("--cfg_cutoff", type=float, default=None,
                    help="CFG truncation fraction: full CFG for the first "
                         "frac of steps, cond-only after")
    ap.add_argument("--deepcache", type=int, default=None,
                    help="DeepCache interval: full UNet every N-th step, "
                         "shallow blocks + cached deep feature in between")
    ap.add_argument("--cn_interval", type=int, default=None,
                    help="final pass: ControlNet forward every N-th step, "
                         "residuals reused in between")
    ap.add_argument("--scheduler", default=None,
                    choices=["ddim", "euler_ancestral", "lcm"],
                    help="override the sampler; 'lcm' is the guidance-free "
                         "few-step loop for LCM(-LoRA)-merged weights "
                         "(pair with --num_steps 4-8)")
    ap.add_argument("--prediction_type", default=None,
                    choices=["epsilon", "v_prediction", "sample"],
                    help="model output parameterization")
    ap.add_argument("--zero_snr", action="store_true", default=None,
                    help="rescale betas to zero terminal SNR "
                         "(arXiv 2305.08891; pair with v_prediction)")
    ap.add_argument("--profile", action="store_true",
                    help="write a torch.profiler trace of the first "
                         "dialogue to <save dir>/profile")
    ap.add_argument("--guidance", action="store_true",
                    help="latent guidance: descend the latents on the "
                         "cross-attention energy in the character and "
                         "final passes (off by default, as the reference "
                         "ships it)")
    ap.add_argument("--no_guidance", action="store_true",
                    help="(deprecated: guidance is off by default)")
    ap.add_argument("--weights", default=None,
                    help="directory of published checkpoints to load the "
                         "bundle from (default: random weights)")
    ap.add_argument("--snapshot", default=None,
                    help="bundle snapshot directory: loaded where it holds "
                         "one, else written after the bundle is built")
    # the JAX driver's other flags parse, and raise (UNPORTED_FLAGS)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--batch_chars", action="store_true", default=None)
    ap.add_argument("--dp_dialogues", type=int, default=None)
    return ap


def check_ported(args) -> None:
    """Raise NotImplementedError for a flag whose feature the port
    lacks."""
    for flag, item in UNPORTED_FLAGS.items():
        value = getattr(args, flag)
        if value not in (None, False):
            raise NotImplementedError(
                f"--{flag} is not ported yet (ROADMAP §1 item {item})")


def load_dataset(dataset_path: str, task: str) -> dict:
    with open(os.path.join(dataset_path, f"{task}.json")) as f:
        return json.load(f)


def apply_pipeline_overrides(cfg, *, cfg_cutoff=None, deepcache=None,
                             scheduler=None, cn_interval=None,
                             prediction_type=None, zero_snr=None):
    """The CLI's sampler-knob overrides on a config, as the JAX package's
    CLI applies them: ``cfg_cutoff_fraction``, ``deepcache_interval``,
    ``scheduler_type`` and ``controlnet_interval`` on ``cfg.pipeline``,
    ``prediction_type`` and ``rescale_zero_terminal_snr`` on
    ``cfg.scheduler``; a knob left at None keeps the config's value."""
    pl = cfg.pipeline
    for field, value in (("cfg_cutoff_fraction", cfg_cutoff),
                         ("deepcache_interval", deepcache),
                         ("scheduler_type", scheduler),
                         ("controlnet_interval", cn_interval)):
        if value is not None:
            pl = dataclasses.replace(pl, **{field: value})
    sc = cfg.scheduler
    if prediction_type is not None:
        sc = dataclasses.replace(sc, prediction_type=prediction_type)
    if zero_snr is not None:
        sc = dataclasses.replace(sc, rescale_zero_terminal_snr=zero_snr)
    return dataclasses.replace(cfg, pipeline=pl, scheduler=sc)


def build_theater(args):
    """The turn's bundle on ``args.device``, under the config's knob
    overrides, as the JAX CLI builds it: the snapshot in ``args.snapshot``
    where it holds one; else ``load_bundle`` of ``args.weights``, or random
    weights from seed 0 with the IP UNet, the vision tower and the
    ControlNet (SD1.5) or the T2I-Adapter (SDXL), then saved to
    ``args.snapshot`` where it is given."""
    from ..config import sd15_config, sdxl_config, tiny_config, tiny_xl_config
    from ..models import snapshot, weights
    from ..pipelines.bundle import init_bundle

    is_xl = args.sd_version == "xl"
    if args.tiny:
        cfg = tiny_xl_config() if is_xl else tiny_config()
    else:
        cfg = sdxl_config() if is_xl else sd15_config()
    cfg = apply_pipeline_overrides(
        cfg,
        cfg_cutoff=args.cfg_cutoff, deepcache=args.deepcache,
        scheduler=args.scheduler, cn_interval=args.cn_interval,
        prediction_type=args.prediction_type, zero_snr=args.zero_snr)
    snap = args.snapshot
    if snap and os.path.exists(os.path.join(snap, "bundle_meta.json")):
        print(f"loading bundle snapshot: {snap}")
        return snapshot.load_bundle_snapshot(
            cfg, snap, tokenizer_assets=args.weights, device=args.device)
    if args.weights:
        bundle = weights.load_bundle(cfg, args.weights, device=args.device)
    else:
        bundle = init_bundle(cfg, 0, device=args.device, with_ip=True,
                             with_vision=True, with_controlnet=not is_xl,
                             with_t2i_adapter=is_xl)
    if snap:
        snapshot.save_bundle_snapshot(bundle, snap)
        print(f"bundle snapshot saved: {snap} (the next run loads it)")
    return bundle


def main(argv: Optional[list] = None) -> None:
    args = make_parser().parse_args(argv)
    check_ported(args)
    bundle = build_theater(args)
    dataset = load_dataset(args.dataset_path, args.task)
    dialogues = list(dataset)
    if args.max_dialogues:
        dialogues = dialogues[: args.max_dialogues]

    save_dir = os.path.join(args.base_save_dir, args.task,
                            f"run{args.force_run_ind}")
    print(f"Save dir: {save_dir}")
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "run_log.jsonl"), "a") as run_log:
        def log(**kw):
            run_log.write(json.dumps(kw) + "\n")
            run_log.flush()

        _run(args, bundle, dataset, dialogues, save_dir, log)


def _run(args, bundle, dataset: dict, dialogues: list, save_dir: str,
         log) -> None:
    """The serial loop: regenerate passes × dialogues × turns × repeats."""
    from ..db import CharacterDB
    from ..theater import Theater
    from ..utils.profiling import trace

    use_time = []
    profiled = False
    canvas = args.box_canvas or (512 if args.tiny else None)
    for regen_ind in range(args.regenerate):
        for d_idx, dialogue in enumerate(dialogues):
            db = CharacterDB(os.path.join(
                args.database_path_base, args.task, str(dialogue)))
            theater = Theater(
                bundle, db, task=args.task, num_steps=args.num_steps,
                guided=args.guidance and not args.no_guidance)
            base = (args.freeze_dialogue_seed
                    if args.freeze_dialogue_seed is not None else d_idx)
            profiling = args.profile and not profiled
            profiled = profiled or profiling
            with (trace(os.path.join(save_dir, "profile")) if profiling
                  else contextlib.nullcontext()):
                t0 = time.time()
                _run_dialogue(args, dataset, dialogue, theater, base,
                              regen_ind, canvas, save_dir, log)
                dt = time.time() - t0
            if profiling:
                print(f"profiler trace: {os.path.join(save_dir, 'profile')}")
            use_time.append(dt)
            print(f"dialogue {dialogue}: {dt:.1f}s "
                  f"(avg {np.mean(use_time):.1f}s, p50 "
                  f"{np.median(use_time):.1f}s)")
            log(event="dialogue", dialogue=str(dialogue),
                seconds=round(dt, 2), phase_summary=theater.timer.summary())

    if use_time:
        print(f"Total {len(use_time)} dialogues, avg {np.mean(use_time):.1f}s,"
              f" p50 {np.median(use_time):.1f}s per 4-turn dialogue")
        log(event="summary", dialogues=len(use_time),
            avg_s=round(float(np.mean(use_time)), 2),
            p50_s=round(float(np.median(use_time)), 2))


def _run_dialogue(args, dataset: dict, dialogue, theater, base: int,
                  regen_ind: int, canvas, save_dir: str, log) -> None:
    """A dialogue's four turns × repeats, with resume and quarantine."""
    for t_idx in range(4):
        turn = f"turn {t_idx + 1}"
        turn_dir = os.path.join(save_dir, str(dialogue), turn)
        if os.path.exists(turn_dir):
            continue  # resume-by-existence (generate.py:193-194)
        if turn not in dataset[dialogue]:
            continue
        spec = build_spec(dataset[dialogue][turn])
        if canvas:
            spec["canvas_height"] = spec["canvas_width"] = canvas
        for rep in range(args.repeats):
            seed = turn_seed(args.seed_offset, base, t_idx, rep,
                             regen=regen_ind)
            try:
                res = theater.run_turn(
                    spec, seed, frozen_step_ratio=args.frozen_step_ratio)
            except Exception as e:
                # error quarantine (generate.py:250-259)
                print(f"[quarantine] {dialogue}/{turn} rep {rep}:")
                traceback.print_exc()
                log(event="quarantine", dialogue=str(dialogue), turn=turn,
                    repeat=rep, seed=seed, error=repr(e))
                continue
            save_image(os.path.join(turn_dir, f"img_{rep}.png"), res.image)
            for i, so in enumerate(res.so_images):
                save_image(os.path.join(turn_dir, f"so_{rep}_{i}.png"), so)
            log(event="turn", dialogue=str(dialogue), turn=turn, repeat=rep,
                seed=seed, seconds=round(res.seconds, 2),
                characters=len(res.so_images), detections=res.detections,
                db_hits=res.db_hits)


if __name__ == "__main__":
    main()
