"""The card-against-CPU backward check of chip_smoke.py, on the CPU.

`chip_smoke.smoke_reference_phase` runs one train step of each SMOKE
family on the card and on the CPU and holds every leaf's score update,
first moment and float update to `backward_check`'s bounds.  Here the
same comparison runs between two CPU runs of one SMOKE state, on bf16
and on f32 activations, within the bounds the card is held to: it passes
when both run the plain versions, and it fails when the second run's
score gradient (kernel 3's function, `masked_matmul_ds`) is negated or
zeroed, so the check on the card can catch a broken kernel 3.

The depth paths' reckoning of kernel launches (`depth_launches`), which
the card's launch counts are held to, is held here to the wrappers'
calls in one train step and round of SMOKE configs cut to a few depths;
and the feature phase's bf16-score bounds to the families they cover."""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import masking
from repro_torch.kernels import bitpack, dispatch
from repro_torch.kernels import masked_matmul as mm
from repro_torch.launch import steps
from repro_torch.models import build_model
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

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


# (arch, layers): a whole group and tails of 1 and 2 rec blocks for the
# hybrid, the dense layer alone and with MoE layers for the MoE family
DEPTHS = [("qwen2-7b", 2), ("deepseek-v2-lite-16b", 2),
          ("deepseek-v2-lite-16b", 4), ("mamba2-370m", 3),
          ("recurrentgemma-9b", 3), ("recurrentgemma-9b", 4),
          ("recurrentgemma-9b", 5), ("recurrentgemma-9b", 6)]
WRAPPERS = {"masked_matmul_fwd": "masked_matmul"}


@pytest.mark.parametrize("arch,layers", DEPTHS)
def test_depth_launches_match_the_wrappers_calls(smoke, arch, layers,
                                                 monkeypatch):
    """One train step (1 cohort, bf16 scores) and one round of `arch`'s
    SMOKE config cut to `layers` call each kernel's wrapper as often as
    `depth_launches` reckons for one pass and one round."""
    calls = {k: 0 for k in dispatch.KERNELS}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call
    for name in dispatch.KERNELS:
        module = bitpack if name in ("pack_bits", "unpack_bits") else mm
        attr = WRAPPERS.get(name, name)
        monkeypatch.setattr(module, attr, counted(name, getattr(module,
                                                                attr)))
    cfg = dataclasses.replace(get_config(arch, smoke=True), n_layers=layers)
    api = build_model(cfg)
    scfg = steps.StepConfig(lam=1.0, lr=0.3, seed=17,
                            score_dtype=torch.bfloat16)
    state = steps.init_fed_state(torch.Generator().manual_seed(1), api,
                                 masking.MaskSpec(), C=1,
                                 score_dtype=torch.bfloat16)
    tokens = torch.randint(0, 256, (1, 2, 8),
                           generator=torch.Generator().manual_seed(2))
    steps.make_train_step(api, scfg)(state, {"tokens": tokens})
    steps.make_round_step(api, scfg)(state)
    expect = {k: 0 for k in dispatch.KERNELS}
    expect.update(smoke.depth_launches(cfg, 1, 1))
    assert calls == expect


def test_bf16_score_bounds_cover_the_new_families(smoke):
    """The feature phase's bf16-score steps: the dense, MoE and SSM
    families held to the "bf16 scores" bounds; the hybrid's first moments
    and float updates to its bf16 spread, its score updates to the
    reference's own bf16-score spread, which is wider."""
    b = smoke.BACKWARD_BOUNDS
    keys = {arch: key for arch, kw, key in smoke.FEATURE_STEPS
            if kw.get("score_dtype") == "bfloat16"}
    assert keys == {"internlm2-1.8b": "bf16 scores",
                    "deepseek-v2-lite-16b": "bf16 scores",
                    "mamba2-370m": "bf16 scores",
                    "recurrentgemma-9b": "bf16 scores hybrid"}
    hybrid = b["bf16 scores hybrid"]
    assert hybrid["first moment"] == hybrid["float update"] == \
        b["bf16 hybrid"]
    rel, cos = hybrid["score update"]
    assert rel >= b["bf16 hybrid"][0] and cos <= b["bf16 hybrid"][1]
