"""The card-against-CPU backward check of chip_smoke.py, on the CPU.

`chip_smoke.smoke_reference_phase` runs one train step of each SMOKE
family on the card and on the CPU and holds every leaf's score update,
first moment and float update to `backward_check`'s bounds.  Here the
same comparison runs between two CPU runs of one SMOKE state, on bf16
and on f32 activations, within the bounds the card is held to: it passes
when both run the plain versions, and it fails when the second run's
score gradient (kernel 3's function, `masked_matmul_ds`) is negated or
zeroed, so the check on the card can catch a broken kernel 3."""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import masked_matmul as mm
from repro_torch.launch import steps

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("internlm2-1.8b", "deepseek-v2-lite-16b", "mamba2-370m",
         "recurrentgemma-9b")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _updates(smoke, arch, f32, monkeypatch=None, broken=None):
    """`first_step_updates` after the smoke reference's round, on the
    CPU, with masked_matmul_ds replaced by `broken(ds)` if given."""
    api, cfg, (state,), toks = smoke.smoke_states(torch, arch, ("cpu",),
                                                  f32=f32)
    steps.make_round_step(api, cfg)(state)
    if broken is not None:
        plain = mm.masked_matmul_ds
        monkeypatch.setattr(mm, "masked_matmul_ds",
                            lambda *a: broken(plain(*a)))
    return smoke.first_step_updates(api, cfg, state, toks)[1]


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_backward_check_passes_on_equal_runs(smoke, arch, f32):
    agree = smoke.backward_check(_updates(smoke, arch, f32),
                                 _updates(smoke, arch, f32), arch,
                                 smoke.backward_bounds(arch, f32))
    assert set(agree) == {"score update", "first moment", "float update"}
    # every masked leaf moved: the regularizer's gradient alone moves all
    n_scores = agree["score update"][2]
    assert n_scores == agree["first moment"][2] > 0
    for rel, cos, n in agree.values():
        assert n > 0 and rel == 0.0 and cos >= 1.0 - 1e-12


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("broken", ["negated", "zeroed"])
def test_backward_check_catches_a_broken_score_gradient(smoke, arch, broken,
                                                        f32, monkeypatch):
    fn = {"negated": torch.neg, "zeroed": torch.zeros_like}[broken]
    want = _updates(smoke, arch, f32)
    got = _updates(smoke, arch, f32, monkeypatch, fn)
    with pytest.raises(smoke.Failed, match="score update|first moment"):
        smoke.backward_check(want, got, arch,
                             smoke.backward_bounds(arch, f32))
