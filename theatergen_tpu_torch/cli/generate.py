"""CMIGBench generation driver.

The port of ``theatergen_tpu/cli/generate.py``.  It keeps the reference
CLI's flags, seed discipline, resume and output tree
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
builds or loads the bundle and saves it there.  ``--batch_chars`` runs
each turn's characters as one batch (``Theater(batch_characters=True)``);
``--dp_dialogues N`` runs waves of N dialogues in lockstep, one turn of
each at a time (``theater.run_turn_wave``: all their characters in one
batch, all their final passes in another), with the serial loop's seeds,
output tree, resume and run log, a ``wave`` event per wave in place of
the ``dialogue`` events; a failed wave reruns its turns serially with the
same seeds, reusing the turns the wave finished.

``--mesh dp=N[,tp=M]`` runs the turns over a ('dp', 'tp') mesh of N·M
ranks (``parallel/mesh.py``; it implies ``--batch_chars``, as in JAX):
the command spawns its ranks itself (``torch.multiprocessing``, start
method ``spawn``), one process per rank, on ``cuda:rank`` (modulo the
cards) or the CPU.  Rank 0 runs this loop, the DB and the output tree;
the other ranks serve its character and final batches
(``parallel/worker.py``).  The device collectives take NCCL on the card
and gloo on the CPU.  A failure on any rank ends every rank with a
non-zero exit.  Runs
on the card unless ``--device`` names another device::

    python -m theatergen_tpu_torch.cli.generate --tiny --device cpu \\
        --dataset_path data/sample --max_dialogues 1 --num_steps 4 \\
        --deepcache 2 --cfg_cutoff 0.5 --cn_interval 2
    python -m theatergen_tpu_torch.cli.generate --sd_version xl \\
        --dataset_path data/sample --max_dialogues 1 --box_canvas 512
    python -m theatergen_tpu_torch.cli.generate --weights ckpt \\
        --snapshot ckpt_snap --dataset_path data/sample --max_dialogues 1
    python -m theatergen_tpu_torch.cli.generate --dataset_path data/sample \\
        --dp_dialogues 2
    python -m theatergen_tpu_torch.cli.generate --dataset_path data/sample \\
        --mesh dp=2 --dp_dialogues 2
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

from ..parallel.worker import RankError

# flags of the JAX driver that raise here, and the ROADMAP §1 item that
# brings each (none left)
UNPORTED_FLAGS: dict = {}


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
    ap.add_argument("--batch_chars", action="store_true",
                    help="run each turn's characters as one batch")
    ap.add_argument("--dp_dialogues", type=int, default=None,
                    help="dialogue waves: N dialogues in lockstep, their "
                         "characters and final passes batched per turn")
    ap.add_argument("--mesh", default=None, metavar="dp=N[,tp=M]",
                    help="('dp','tp') mesh of N*M ranks, spawned by this "
                         "command: character batches and dialogue waves "
                         "sharded over dp, the UNets' heads and FF columns "
                         "over tp (implies --batch_chars)")
    return ap


def check_ported(args) -> None:
    """Raise NotImplementedError for a flag whose feature the port
    lacks."""
    for flag, item in UNPORTED_FLAGS.items():
        value = getattr(args, flag)
        if value not in (None, False):
            raise NotImplementedError(
                f"--{flag} is not ported yet (ROADMAP §1 item {item})")


def parse_mesh_arg(spec: Optional[str], device="cuda",
                   backend: Optional[str] = None):
    """'dp=N[,tp=M]' → ``MeshConfig`` (None passes through), with the JAX
    CLI's messages for an unknown axis and for too few devices: a rank
    per card under NCCL; under gloo (the CPU, or several ranks on one
    card) the host's cores bound it."""
    if not spec:
        return None
    from ..config import MeshConfig

    kw = {"dp": 1, "tp": 1}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in kw:
            raise SystemExit(f"--mesh: unknown axis {k!r} (use dp=N[,tp=M])")
        kw[k] = int(v)
    import torch

    n = kw["dp"] * kw["tp"]
    if torch.device(device).type == "cuda" and backend in (None, "nccl"):
        have = torch.cuda.device_count()
    else:
        have = os.cpu_count() or 1
    if n > have:
        raise SystemExit(f"--mesh {spec}: needs {n} devices, have {have}")
    return MeshConfig(dp=kw["dp"], tp=kw["tp"])


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


def build_theater(args, save_snapshot: bool = True):
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
        prediction_type=getattr(args, "prediction_type", None),
        zero_snr=getattr(args, "zero_snr", None))
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
    if snap and save_snapshot:
        snapshot.save_bundle_snapshot(bundle, snap)
        print(f"bundle snapshot saved: {snap} (the next run loads it)")
    return bundle


def main(argv: Optional[list] = None, **launch) -> None:
    """The CLI; ``launch`` goes to :func:`launch_mesh` under ``--mesh``."""
    args = make_parser().parse_args(argv)
    check_ported(args)
    if args.mesh is None:
        run_program(args, build_theater(args), None)
    else:
        launch_mesh(__name__, args, argv, **launch)


def launch_mesh(program: str, args, argv, *, backend: Optional[str] = None,
                timeout_s: Optional[float] = None,
                join_s: Optional[float] = None) -> None:
    """Run ``program`` (a module with ``make_parser`` and ``run_program(args,
    bundle, mesh)``) over ``args.mesh``'s ranks: in this process for one
    rank, else in as many spawned processes (``parallel/worker.spawn``).
    ``backend`` overrides the device collectives' (gloo lets several ranks
    share one card); ``timeout_s`` bounds every process group's wait for a
    peer, rank 0's commands included (default: ``parallel/mesh``'s); past
    ``join_s`` every rank is killed and ``TimeoutError`` raised."""
    from ..parallel import worker

    mesh_cfg = parse_mesh_arg(args.mesh, args.device, backend)
    world = mesh_cfg.dp * mesh_cfg.tp
    opts = (argv, program, backend, timeout_s)
    if world == 1:
        # one rank: this process, over a one-rank process group
        _mesh_rank(0, 1, worker.free_address(), *opts)
    else:
        worker.spawn(_mesh_rank, world, opts, timeout_s=join_s)


def _mesh_rank(rank: int, world: int, address: str, argv, program: str,
               backend: Optional[str] = None,
               timeout_s: Optional[float] = None) -> None:
    """One rank of ``--mesh``: rank 0 runs ``program``, the others serve it.
    Each builds the bundle as rank 0 does (the same seed or files), after
    rank 0, which alone writes a snapshot."""
    import importlib
    import sys

    import torch.distributed as dist

    from ..parallel import mesh as mesh_lib
    from ..parallel import worker

    prog = importlib.import_module(program)
    args = prog.make_parser().parse_args(argv)
    mesh_cfg = parse_mesh_arg(args.mesh, args.device, backend)
    if "OMP_NUM_THREADS" not in os.environ:
        # the ranks share the host's cores (CPU meshes compute on them)
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    wait = mesh_lib.DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s
    mesh_lib.init_distributed(args.device, backend=backend, address=address,
                              rank=rank, world_size=world, timeout_s=wait)
    try:
        mesh = mesh_lib.make_mesh(
            mesh_cfg.dp, mesh_cfg.tp, device=args.device, timeout_s=wait,
            command_timeout_s=(mesh_lib.COMMAND_TIMEOUT_S if timeout_s is None
                               else timeout_s))
        args.device = str(mesh.device)
        if rank == 0:
            bundle = build_theater(args)
        dist.barrier(group=mesh.group("host"))
        if rank != 0:
            bundle = build_theater(args, save_snapshot=False)
        code = worker.run_rank(
            mesh, lambda: prog.run_program(args, bundle, mesh), bundle)
    finally:
        dist.destroy_process_group()
    if code:
        sys.exit(code)


def run_program(args, bundle, mesh) -> None:
    """The CLI's loop over the dataset (rank 0's program under a mesh)."""
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

        if args.dp_dialogues:
            _run_waves(args, bundle, dataset, dialogues, save_dir, log,
                       mesh)
        else:
            _run(args, bundle, dataset, dialogues, save_dir, log, mesh)


def _run(args, bundle, dataset: dict, dialogues: list, save_dir: str,
         log, mesh=None) -> None:
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
                guided=args.guidance and not args.no_guidance, mesh=mesh,
                batch_characters=args.batch_chars)
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


def _run_waves(args, bundle, dataset: dict, dialogues: list, save_dir: str,
               log, mesh=None) -> None:
    """Dialogue waves (the JAX CLI's ``_run_wave_mode``): waves of
    ``--dp_dialogues`` dialogues advance turn by turn in lockstep through
    ``run_turn_wave``.  Seeds, output tree, resume by existence and
    quarantine are the serial loop's; a wave that fails reruns its turns
    serially with the same seeds, reusing those the wave finished
    (``WaveFailure.results``: their DB writes are durable)."""
    from ..db import CharacterDB
    from ..theater import Theater, run_turn_wave
    from ..utils.profiling import trace

    width = args.dp_dialogues
    canvas = args.box_canvas or (512 if args.tiny else None)
    use_time, n_dialogues = [], 0
    profiled = False
    for regen_ind in range(args.regenerate):
        for w0 in range(0, len(dialogues), width):
            wave = dialogues[w0:w0 + width]
            n_dialogues += len(wave)
            theaters = [Theater(
                bundle, CharacterDB(os.path.join(
                    args.database_path_base, args.task, str(dialogue))),
                task=args.task, num_steps=args.num_steps,
                guided=args.guidance and not args.no_guidance, mesh=mesh,
                batch_characters=True) for dialogue in wave]
            profiling = args.profile and not profiled
            profiled = profiled or profiling
            with (trace(os.path.join(save_dir, "profile")) if profiling
                  else contextlib.nullcontext()):
                t0 = time.time()
                for t_idx in range(4):
                    _run_wave_turn(args, dataset, wave, w0, theaters, t_idx,
                                   regen_ind, canvas, save_dir, log,
                                   run_turn_wave)
                dt = time.time() - t0
            if profiling:
                print(f"profiler trace: {os.path.join(save_dir, 'profile')}")
            use_time.append(dt / len(wave))
            print(f"wave {wave}: {dt:.1f}s ({dt / len(wave):.1f}s/dialogue, "
                  f"p50 {np.median(use_time):.1f}s)")
            log(event="wave", dialogues=[str(d) for d in wave],
                seconds=round(dt, 2),
                phase_summary=theaters[0].timer.summary())
    if use_time:
        print(f"Total {len(use_time)} waves, avg {np.mean(use_time):.1f}s, "
              f"p50 {np.median(use_time):.1f}s per 4-turn dialogue")
        log(event="summary", dialogues=n_dialogues,
            avg_s=round(float(np.mean(use_time)), 2),
            p50_s=round(float(np.median(use_time)), 2))


def _run_wave_turn(args, dataset: dict, wave: list, w0: int, theaters: list,
                   t_idx: int, regen_ind: int, canvas, save_dir: str, log,
                   run_turn_wave) -> None:
    """Turn ``t_idx`` of a wave's dialogues × repeats, with resume and
    quarantine."""
    turn = f"turn {t_idx + 1}"
    sel, specs = [], []
    for i, dialogue in enumerate(wave):
        if os.path.exists(os.path.join(save_dir, str(dialogue), turn)):
            continue  # resume-by-existence (generate.py:193-194)
        if turn not in dataset[dialogue]:
            continue
        spec = build_spec(dataset[dialogue][turn])
        if canvas:
            spec["canvas_height"] = spec["canvas_width"] = canvas
        sel.append(i)
        specs.append(spec)
    if not sel:
        return
    for rep in range(args.repeats):
        seeds = [turn_seed(args.seed_offset,
                           args.freeze_dialogue_seed
                           if args.freeze_dialogue_seed is not None
                           else w0 + i, t_idx, rep, regen=regen_ind)
                 for i in sel]
        try:
            results = run_turn_wave([theaters[i] for i in sel], specs, seeds,
                                    frozen_step_ratio=args.frozen_step_ratio)
        except RankError:
            raise       # a failed rank ends the mesh: no quarantine
        except Exception as e:
            # quarantine (generate.py:250-259): one bad dialogue must not
            # sink its wave-mates, so the wave's turns rerun serially
            print(f"[quarantine] wave {[wave[i] for i in sel]}/{turn} "
                  f"rep {rep}: rerunning its turns serially")
            traceback.print_exc()
            partial = getattr(e, "results", {})
            results = []
            for w_idx, (i, spec, seed) in enumerate(zip(sel, specs, seeds)):
                if w_idx in partial:
                    results.append(partial[w_idx])
                    continue
                try:
                    results.append(theaters[i].run_turn(
                        spec, seed, frozen_step_ratio=args.frozen_step_ratio))
                except RankError:
                    raise
                except Exception as e2:
                    print(f"[quarantine] {wave[i]}/{turn} rep {rep}:")
                    traceback.print_exc()
                    log(event="quarantine", dialogue=str(wave[i]), turn=turn,
                        repeat=rep, seed=seed, error=repr(e2))
                    results.append(None)
        for i, seed, res in zip(sel, seeds, results):
            if res is not None:
                _save_turn(save_dir, wave[i], turn, rep, seed, res, log)


def _save_turn(save_dir: str, dialogue, turn: str, rep: int, seed: int, res,
               log) -> None:
    """A turn's images into the output tree and its ``turn`` event."""
    turn_dir = os.path.join(save_dir, str(dialogue), turn)
    save_image(os.path.join(turn_dir, f"img_{rep}.png"), res.image)
    for i, so in enumerate(res.so_images):
        save_image(os.path.join(turn_dir, f"so_{rep}_{i}.png"), so)
    log(event="turn", dialogue=str(dialogue), turn=turn, repeat=rep,
        seed=seed, seconds=round(res.seconds, 2),
        characters=len(res.so_images), detections=res.detections,
        db_hits=res.db_hits)


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
            except RankError:
                raise       # a failed rank ends the mesh: no quarantine
            except Exception as e:
                # error quarantine (generate.py:250-259)
                print(f"[quarantine] {dialogue}/{turn} rep {rep}:")
                traceback.print_exc()
                log(event="quarantine", dialogue=str(dialogue), turn=turn,
                    repeat=rep, seed=seed, error=repr(e))
                continue
            _save_turn(save_dir, dialogue, turn, rep, seed, res, log)


if __name__ == "__main__":
    main()
