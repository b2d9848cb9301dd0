"""The system under test: the port's bundle and turn server, driven in a
closed loop.

``meta_bundle`` builds the port's bundle on the meta device and
``load_bundle`` gives its modules the benchmark's tensors, so the weights
exist once.  ``Load`` opens the sessions on a ``TheaterServer``, writes
the DB entries each session needs before its first turn through the DB
write a miss makes (the port's ``encode_ip_image`` of the image, then the
session's ``CharacterDB.save``), and runs rounds: one turn of every
session submitted, all of them awaited, then the next.  Each turn is
timed on the host clock from its submit to its future's result (the
images on the host).
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .traffic import Traffic

BUNDLE_MODULES = ("unet", "vae", "text", "text2", "unet_ip", "image_proj",
                  "vision", "controlnet", "t2i_adapter")


def meta_bundle(pcfg, flags: dict):
    """The port's bundle of ``pcfg`` on the meta device, and each module's
    parameter dtypes."""
    from theatergen_tpu_torch.pipelines.bundle import init_bundle

    b = init_bundle(pcfg, 0, device="meta", **flags)
    dtypes = {}
    for name in BUNDLE_MODULES:
        m = getattr(b, name, None)
        if m is not None:
            dtypes[name] = {k: v.dtype for k, v in m.state_dict().items()}
    return b, dtypes


def load_bundle(b, states: Dict[str, Dict[str, torch.Tensor]]):
    """The meta bundle ``b`` with every module given its tensors."""
    for name, sd in states.items():
        getattr(b, name).load_state_dict(sd, strict=True, assign=True)
    for name in BUNDLE_MODULES:
        m = getattr(b, name, None)
        if m is None:
            continue
        left = [k for k, v in list(m.named_parameters())
                + list(m.named_buffers()) if v.is_meta]
        if left:
            raise RuntimeError(f"{name}: {left[:3]} have no values")
    return b


def db_image(seed: int, size: int, device) -> torch.Tensor:
    """A smooth random RGB image ``[size, size, 3]`` in [0, 1] from
    ``seed``: an 8×8 draw, upsampled bilinearly."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    low = torch.rand((1, 3, 8, 8), generator=gen, device=device)
    img = F.interpolate(low, size=(size, size), mode="bilinear",
                        align_corners=False)
    return img[0].permute(1, 2, 0).contiguous()


class Load:
    """The sessions of one traffic file over one server."""

    def __init__(self, bundle, traffic: Traffic, db_root: str,
                 num_steps: Optional[int] = None, prefix: str = "s"):
        from theatergen_tpu_torch.pipelines.character import encode_ip_image
        from theatergen_tpu_torch.serve import TheaterServer

        srv = traffic.mix["server"]
        kw = {} if num_steps is None else dict(num_steps=num_steps)
        self.server = TheaterServer(
            bundle, db_root, max_wave=int(srv["max_wave"]),
            batch_window_s=float(srv["batch_window_s"]),
            wave_policy=srv["wave_policy"],
            max_queue=int(srv.get("max_queue", 64)), **kw)
        self.traffic = traffic
        self.ids = [f"{prefix}{k}" for k in range(traffic.sessions)]
        self.next_turn = [0] * traffic.sessions
        self.db_images: List[Dict[int, torch.Tensor]] = []
        size = bundle.cfg.pipeline.height
        for k, sid in enumerate(self.ids):
            th = self.server.open_session(sid).theater
            images = {}
            for obj_id, img_seed in traffic.prefill(k):
                img = db_image(img_seed, size, bundle.device)
                emb = encode_ip_image(bundle, img[None])[0]
                th.db.save(obj_id, img.float().cpu().numpy(),
                           emb.float().cpu().numpy().reshape(-1))
                images[obj_id] = img
            self.db_images.append(images)

    def round(self, keep=()) -> List[dict]:
        """One turn of every session: submitted in session order, then
        awaited.  Returns one record per turn: ``session``, ``n``,
        ``submit`` and ``done`` (host clock), ``ok``, and for the sessions
        in ``keep`` the spec, seed and TurnResult."""
        recs, futs = [], []
        for k, sid in enumerate(self.ids):
            spec, seed = self.traffic.turn(k, self.next_turn[k])
            rec = dict(session=k, n=self.next_turn[k])
            self.next_turn[k] += 1
            if k in keep:
                rec.update(spec=spec, seed=seed)
            rec["submit"] = time.perf_counter()
            fut = self.server.submit(sid, spec, seed)
            fut.add_done_callback(
                lambda _f, r=rec: r.__setitem__("done", time.perf_counter()))
            recs.append(rec)
            futs.append(fut)
        for rec, fut in zip(recs, futs):
            try:
                res = fut.result()
            except Exception:           # noqa: BLE001 — counted as failed
                rec["ok"], rec["error"] = False, traceback.format_exc()
                continue
            rec["ok"] = True
            rec["done"] = rec.get("done", time.perf_counter())
            if rec["session"] in keep:
                rec["result"] = res
        return recs

    def timers(self):
        """The PhaseTimer of every session's Theater."""
        return [self.server.sessions[sid].theater.timer for sid in self.ids]

    def close(self) -> None:
        self.server.close()


def session_root(name: str) -> str:
    """A directory for the sessions' DBs under ``TMPDIR``, removed by the
    caller."""
    import tempfile

    return tempfile.mkdtemp(prefix=f"bench-{name}-",
                            dir=os.environ.get("TMPDIR") or None)
