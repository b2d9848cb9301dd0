"""The served bundle's weights, made on the device from the seed.

One ``torch.randn`` per dtype over every parameter of the bundle, drawn
from a generator on the device seeded by ``--seed``, in the dtype each
module is served in; each parameter is a view of that draw, scaled or
shifted by its layer's rule, as trained checkpoints hold them: linear
and convolution weights N(0, 1/fan_in) (lecun normal), their biases
N(0, 0.02²), embeddings N(0, 0.02²), norm scales 1 + N(0, 0.1²) and
shifts N(0, 0.1²), a module's own parameters N(0, init_std²) (0.02
unless it sets it).  No bias or affine step is zero or one, so the check
sees a kernel that drops one.  The
names and shapes come from the plain reference's modules, and the program
must hold the same: both sides load these very tensors, the program as
they are, the reference cast to fp32.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch
import torch.nn as nn

from reference.turn import build_skeleton


def _rules(module: nn.Module) -> List[Tuple[str, str, float]]:
    """``(parameter name, rule, std)`` of every parameter of ``module``."""
    out = []
    for mname, m in module.named_modules():
        prefix = f"{mname}." if mname else ""
        for pname, p in m.named_parameters(recurse=False):
            name = prefix + pname
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                rule = ("normal", m.weight[0].numel() ** -0.5) \
                    if pname == "weight" else ("normal", BIAS_STD)
            elif isinstance(m, nn.Embedding):
                rule = ("normal", 0.02)
            elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                rule = ("one_plus", NORM_STD) if pname == "weight" \
                    else ("normal", NORM_STD)
            else:
                std = getattr(m, "init_std", 0.02)
                rule = ("normal", std) if std else ("zero", 0.0)
            out.append((name,) + rule)
    return out


def make_states(specs: Dict[str, tuple], dtypes: Dict[str, Dict[str, torch.dtype]],
                names: Iterable[str], seed: int, device
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{module: state dict}`` for the modules ``names`` of ``specs``
    (``reference.turn.module_specs``), each parameter in the dtype
    ``dtypes[module][parameter]`` (the served module's)."""
    names = list(names)
    plan = []                       # (module, param, rule, std, shape, dtype)
    for mod in names:
        skel = build_skeleton(specs[mod])
        shapes = dict(skel.state_dict().items())
        want = dtypes[mod]
        if set(shapes) != set(want):
            extra = sorted(set(shapes) ^ set(want))[:4]
            raise ValueError(f"{mod}: the program's parameters are not the "
                             f"reference's ({extra} ...)")
        for pname, rule, std in _rules(skel):
            plan.append((mod, pname, rule, std, tuple(shapes[pname].shape),
                         want[pname]))
        if len({p for m, p, *_ in plan if m == mod}) != len(shapes):
            raise ValueError(f"{mod}: buffers outside the parameters")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    states: Dict[str, Dict[str, torch.Tensor]] = {m: {} for m in names}
    for dtype in sorted({p[5] for p in plan}, key=str):
        group = [p for p in plan if p[5] == dtype]
        # every parameter starts on a 256-byte boundary, as an allocation
        # does (the kernels' tensor maps need 16-byte aligned addresses)
        align = max(1, ALIGN_BYTES // torch.empty((), dtype=dtype)
                    .element_size())
        total = sum(_padded(_numel(p[4]), align) for p in group)
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        off = 0
        with torch.no_grad():
            for mod, pname, rule, std, shape, _ in group:
                n = _numel(shape)
                view = flat[off:off + n].view(shape)
                off += _padded(n, align)
                if rule == "normal":
                    view.mul_(std)
                elif rule == "one_plus":
                    view.mul_(std).add_(1.0)
                else:
                    view.zero_()
                states[mod][pname] = view
    return states


ALIGN_BYTES = 256
BIAS_STD = 0.02
NORM_STD = 0.1


def _padded(n: int, align: int) -> int:
    return -(-n // align) * align


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
