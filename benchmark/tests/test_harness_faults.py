"""Whole runs of the tiny cells on the CPU (the harness's look for a card
skipped): a sound run comes out correct, and each fault a cell can have,
planted in the program underneath the timed path, comes out not
correct: among them a kernel's bias or affine term left out, which the
drawn weights make non-zero."""

import pytest
import torch

from harness_tiny import TINY_CELLS, make_root

from harness.main import run_cell

SEED = 2 ** 31 + 777


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, trace=False):
    return run_cell(cell, SEED, 0.0, trace, device="cpu", root=root)


def _step_unchanged(mp):
    from theatergen_tpu_torch.ops import scheduler

    mp.setattr(scheduler.DeviceSampler, "step",
               lambda self, out, i, sample, noise=None: sample)


def _half_batch_left_out(mp):
    """Every UNet evaluation of a batch of four rows or more computes the
    first half of its rows and copies them over the rest."""
    from theatergen_tpu_torch.models.unet import UNet2DCondition

    orig = UNet2DCondition.forward

    def forward(self, sample, *args, **kwargs):
        out = orig(self, sample, *args, **kwargs)
        eps = out[0] if isinstance(out, tuple) else out
        n = eps.shape[0]
        if n >= 4:
            eps[n // 2:] = eps[:n - n // 2][:n // 2]
        return out

    mp.setattr(UNet2DCondition, "forward", forward)


def _answer_altered(mp):
    """Every decoded image is brightened where it is produced."""
    from theatergen_tpu_torch.pipelines import sd

    orig = sd.decode_with
    mp.setattr(sd, "decode_with",
               lambda vae, s, lat: torch.clamp(orig(vae, s, lat) + 0.02,
                                               0.0, 1.0))


def _without(mp, cls, param_of):
    """``cls.forward`` runs with the parameter ``param_of(module)`` zeroed,
    as a kernel that leaves that term out computes."""
    orig = cls.forward

    def forward(self, *args, **kwargs):
        p = param_of(self)
        saved = p.detach().clone()
        with torch.no_grad():
            p.zero_()
        try:
            return orig(self, *args, **kwargs)
        finally:
            with torch.no_grad():
                p.copy_(saved)

    mp.setattr(cls, "forward", forward)


def _ff_bias_dropped(mp):
    """Every feed-forward leaves out its up-projection's bias (the FF
    kernel's ``b1``)."""
    from theatergen_tpu_torch.models.layers import FeedForward

    _without(mp, FeedForward, lambda m: m.net[0].proj.bias)


def _norm_shift_dropped(mp):
    """Every GroupNorm leaves out its shift (the GroupNorm kernel's
    ``bias``)."""
    from theatergen_tpu_torch.models.layers import GroupNorm

    _without(mp, GroupNorm, lambda m: m.bias)


FAULTS = {"step_unchanged": _step_unchanged,
          "half_batch_left_out": _half_batch_left_out,
          "answer_altered": _answer_altered,
          "ff_bias_dropped": _ff_bias_dropped,
          "norm_shift_dropped": _norm_shift_dropped}


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_sound_run_is_correct(root, cell):
    res = _run(root, cell)
    assert res["correct"], res["check"]
    assert res["attempted"] >= 4 and res["failed"] == 0
    assert list(res)[-1] == "check"


# the serial cell runs no batch beyond the CFG pair: it cannot leave half
# of one out
CASES = [(c, f) for c in TINY_CELLS for f in sorted(FAULTS)
         if (c, f) != ("tiny_xl_serial", "half_batch_left_out")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run(root, cell)
    assert not res["correct"], res["check"]


def test_traced_run_reports_layers(root):
    res = _run(root, "tiny_serve4", trace=True)
    assert res["correct"]
    assert {"char_pass_s_per_turn", "final_pass_s_per_turn",
            "eval_host_ms"} <= set(res["metrics"])
    # no device metric from a CPU run
    assert not {"unet_eval_device_ms", "device_idle_pct",
                "flash_attention_roofline", "mfu_pct"} & set(res["metrics"])
    assert "breakdown" in res and res["device"]["platform"] == "cpu"
