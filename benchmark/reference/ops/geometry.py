"""Box and mask geometry as plain tensor functions.

The port of the parts of ``theatergen_tpu/ops/geometry.py`` that the
composition, the collage, the attention-mask fallback and SAM's mask
selection call.  Boxes are
``[x_min, y_min, x_max, y_max]``, normalised to [0, 1] unless noted.  Box
coordinates and shifts may be tensors on the device: nothing here copies a
value to the host.
"""

from __future__ import annotations

from typing import Tuple

import torch


def centered_box(box: torch.Tensor, horizontal_only: bool = True,
                 vertical_center: float = 0.5) -> torch.Tensor:
    """Recentre a normalised box (horizontally, or both ways)."""
    x0, y0, x1, y1 = box.unbind(-1)
    w = x1 - x0
    nx0, nx1 = 0.5 - w / 2, 0.5 + w / 2
    if horizontal_only:
        return torch.stack([nx0, y0, nx1, y1], dim=-1)
    h = y1 - y0
    return torch.stack([nx0, vertical_center - h / 2, nx1,
                        vertical_center + h / 2], dim=-1)


def scale_box(box: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Normalised box → int32 pixel box; the size is rounded, not the far
    corner, so a shifted box keeps its size (round half to even, as
    ``jnp.round``)."""
    box = box.float()
    x0 = torch.round(box[..., 0] * w)
    y0 = torch.round(box[..., 1] * h)
    bw = torch.round((box[..., 2] - box[..., 0]) * w)
    bh = torch.round((box[..., 3] - box[..., 1]) * h)
    x1 = torch.clamp(x0 + bw, 0, w)
    y1 = torch.clamp(y0 + bh, 0, h)
    return torch.stack([torch.clamp(x0, 0, w), torch.clamp(y0, 0, h), x1, y1],
                       dim=-1).to(torch.int32)


def box_mask(box: torch.Tensor, h: int, w: int,
             dtype=torch.float32) -> torch.Tensor:
    """Normalised box (``[..., 4]``) → ``[..., h, w]`` {0, 1} mask."""
    ib = scale_box(box, h, w)
    rows = torch.arange(h, device=box.device, dtype=torch.int32)[:, None]
    cols = torch.arange(w, device=box.device, dtype=torch.int32)[None, :]
    corner = [ib[..., i, None, None] for i in range(4)]
    m = ((rows >= corner[1]) & (rows < corner[3])
         & (cols >= corner[0]) & (cols < corner[2]))
    return m.to(dtype)


def mask_to_box(mask: torch.Tensor, enlarge_by_one: bool = True
                ) -> torch.Tensor:
    """Tight int32 pixel box ``[x0, y0, x1, y1]`` around the mask's
    nonzero pixels (last corner inclusive, then each side moved out by one
    where ``enlarge_by_one``); an empty mask gives the whole image."""
    h, w = mask.shape[-2:]
    on = mask > 0
    rows, cols = on.any(-1), on.any(-2)
    ridx = torch.arange(h, device=mask.device, dtype=torch.int32)
    cidx = torch.arange(w, device=mask.device, dtype=torch.int32)
    big = torch.tensor(10 ** 9, dtype=torch.int32, device=mask.device)
    y0 = torch.where(rows, ridx, big).amin(-1)
    y1 = torch.where(rows, ridx, -big).amax(-1)
    x0 = torch.where(cols, cidx, big).amin(-1)
    x1 = torch.where(cols, cidx, -big).amax(-1)
    if enlarge_by_one:
        y0, x0 = torch.clamp(y0 - 1, min=0), torch.clamp(x0 - 1, min=0)
        y1, x1 = torch.clamp(y1 + 1, max=h), torch.clamp(x1 + 1, max=w)
    box = torch.stack([x0, y0, x1, y1], dim=-1)
    full = torch.tensor([0, 0, w, h], dtype=torch.int32, device=mask.device)
    return torch.where(on.flatten(-2).any(-1)[..., None], box, full)


def mask_center(mask: torch.Tensor, normalize: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mass centre (x, y) of a mask; an empty mask gives the image centre."""
    h, w = mask.shape[-2:]
    m = mask.float()
    total = m.sum((-2, -1))
    xs = torch.arange(w, dtype=torch.float32, device=mask.device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=mask.device)[:, None]
    safe = torch.clamp(total, min=1e-6)
    x = torch.where(total > 0, (m * xs).sum((-2, -1)) / safe,
                    torch.full_like(total, (w - 1) / 2.0))
    y = torch.where(total > 0, (m * ys).sum((-2, -1)) / safe,
                    torch.full_like(total, (h - 1) / 2.0))
    if normalize:
        x, y = x / w, y / h
    return x, y


def _shift_index(n: int, d: torch.Tensor, device):
    """Source index of each output position for a shift by ``d`` along an
    axis of length ``n``, and whether it falls inside."""
    src = torch.arange(n, device=device) - d.to(device=device,
                                                dtype=torch.long)
    inside = (src >= 0) & (src < n)
    return src.clamp(0, n - 1), inside


def shift2d(x: torch.Tensor, dy, dx, dims: Tuple[int, int] = (-2, -1)
            ) -> torch.Tensor:
    """Shift two axes of ``x`` (the trailing two by default) by integer
    offsets, zero-filling; positive ``dy``/``dx`` move the content towards
    higher indices.  The offsets may be 0-dim tensors on the device."""
    ay, ax = (d % x.ndim for d in dims)
    dy, dx = (torch.as_tensor(v) for v in (dy, dx))
    ry, in_y = _shift_index(x.shape[ay], dy, x.device)
    rx, in_x = _shift_index(x.shape[ax], dx, x.device)
    out = x.index_select(ay, ry).index_select(ax, rx)
    keep = in_y[:, None] & in_x[None, :]
    shape = [1] * x.ndim
    shape[ay], shape[ax] = x.shape[ay], x.shape[ax]
    return out * keep.reshape(shape).to(x.dtype)


def iou(mask: torch.Tensor, masks: torch.Tensor, eps: float = 1e-6
        ) -> torch.Tensor:
    """IoU of ``mask [h, w]`` against each of ``masks [n, h, w]``, nonzero
    counting as inside; fp32 ``[n]``."""
    a, b = mask[None].bool(), masks.bool()
    inter = (a & b).sum((1, 2)).float()
    return inter / ((a | b).sum((1, 2)).float() + eps)


def box_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """IoU of normalised boxes ``[..., 4]`` (broadcastable)."""
    def side(x, i):
        return torch.clamp(x[..., i + 2] - x[..., i], min=0)

    x0 = torch.maximum(a[..., 0], b[..., 0])
    y0 = torch.maximum(a[..., 1], b[..., 1])
    x1 = torch.minimum(a[..., 2], b[..., 2])
    y1 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(x1 - x0, min=0) * torch.clamp(y1 - y0, min=0)
    return inter / (side(a, 0) * side(a, 1) + side(b, 0) * side(b, 1)
                    - inter + eps)


def downsample_max(mask: torch.Tensor, out_h: int, out_w: int
                   ) -> torch.Tensor:
    """Max-pool the trailing two axes down to ``(out_h, out_w)`` by whole
    factors."""
    h, w = mask.shape[-2:]
    if h % out_h or w % out_w:
        raise ValueError(f"downsample_max: {(h, w)} is not a whole multiple "
                         f"of {(out_h, out_w)}")
    x = mask.reshape(*mask.shape[:-2], out_h, h // out_h, out_w, w // out_w)
    return x.amax((-3, -1))


def upsample_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest-neighbour upsample of the trailing two axes by whole
    factors."""
    h, w = x.shape[-2:]
    if out_h % h or out_w % w:
        raise ValueError(f"upsample_nearest: {(out_h, out_w)} is not a "
                         f"whole multiple of {(h, w)}")
    return x.repeat_interleave(out_h // h, -2).repeat_interleave(out_w // w,
                                                                 -1)


def linear_weights(in_size: int, out_size: int, scale, translation,
                   antialias: bool = True, device=None) -> torch.Tensor:
    """``[in_size, out_size]`` fp32 weights of a linear (triangle-kernel)
    resample where output sample ``o`` sits at input ``(o + 0.5 -
    translation) / scale - 0.5``: the kernel widened by 1/scale when it
    shrinks (``antialias``), each column normalised to sum 1, and zero
    where the sample falls outside the input, as
    ``jax.image.scale_and_translate`` builds them.  A float ``scale`` is
    inverted in double precision first, as a Python scale is there."""
    f32 = dict(dtype=torch.float32, device=device)
    if isinstance(scale, torch.Tensor):
        inv = 1.0 / scale.to(**f32)
    else:
        inv = torch.full((), 1.0 / scale, **f32)
    if isinstance(translation, torch.Tensor):
        translation = translation.to(**f32)
    else:
        translation = torch.full((), translation, **f32)
    kscale = torch.clamp(inv, min=1.0) if antialias else 1.0
    sample = ((torch.arange(out_size, **f32) + 0.5) * inv
              - translation * inv - 0.5)
    dist = (sample[None, :] - torch.arange(in_size, **f32)[:, None]).abs()
    wts = torch.clamp(1.0 - dist / kscale, min=0.0)
    total = wts.sum(0, keepdim=True)
    wts = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                      wts / torch.where(total != 0, total, 1.0),
                      torch.zeros_like(wts))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], wts, torch.zeros_like(wts))


def _resample(x: torch.Tensor, axis: int, n: int, scale, translation,
              antialias: bool = True) -> torch.Tensor:
    wmat = linear_weights(x.shape[axis], n, scale, translation, antialias,
                          device=x.device)
    return torch.tensordot(x.movedim(axis, -1), wmat, dims=1).movedim(-1,
                                                                      axis)


def scale_and_translate(x: torch.Tensor, out_hw: Tuple[int, int],
                        dims: Tuple[int, int], scale, translation,
                        antialias: bool = True) -> torch.Tensor:
    """fp32 linear resample of two axes of ``x`` to ``out_hw``, where
    output = input · scale + translation per axis
    (``jax.image.scale_and_translate`` with the linear kernel);
    ``scale``/``translation`` are (y, x) pairs of floats or 0-dim
    tensors."""
    x = x.float()
    for axis, n, s, t in zip(dims, out_hw, scale, translation):
        x = _resample(x, axis, n, s, t, antialias)
    return x


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int
                    ) -> torch.Tensor:
    """fp32 bilinear resize of the trailing two axes (HW or NCHW),
    antialiased when it shrinks (``jax.image.resize(..., "bilinear")``);
    an axis whose size does not change is left as it is."""
    x = img.float()
    for axis, n in ((-2, out_h), (-1, out_w)):
        if x.shape[axis] != n:
            x = _resample(x, axis, n, n / x.shape[axis], 0.0)
    return x


def paste_region(canvas: torch.Tensor, patch: torch.Tensor, y0, x0,
                 mask: torch.Tensor) -> torch.Tensor:
    """Paste ``patch [..., ph, pw]`` onto ``canvas`` at ``(y0, x0)`` under
    ``mask [ph, pw]``."""
    ph, pw = patch.shape[-2:]
    h, w = canvas.shape[-2:]
    pad = (0, w - pw, 0, h - ph)
    patch_s = shift2d(torch.nn.functional.pad(patch, pad), y0, x0)
    mask_s = shift2d(torch.nn.functional.pad(mask.to(patch.dtype), pad),
                     y0, x0)
    return canvas * (1 - mask_s) + patch_s * mask_s
