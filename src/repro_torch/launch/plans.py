"""Launch plans: registry names -> fed state, train step, round step and
batch layout for `repro_torch.launch.train`.  Importing this module
registers the mask-training plans (fedpm_reg, fedpm, fedmask) and the
float reference (fedavg: one float state, flat batches, no round)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.api import registry
from repro_torch.core import masking
from repro_torch.launch import steps as steplib


@dataclasses.dataclass
class LaunchPlan:
    name: str
    state: Any
    step_fn: Callable                 # (state, batch) -> (state, metrics)
    round_fn: Optional[Callable]      # (state, participation) -> (state, metrics)
    make_batch: Callable              # (generator, tokens, batch, seq) -> batch


def _cohort_batch(cohorts: int):
    def make_batch(gen, toks, batch, seq):
        """(cohorts, batch, seq) windows of the token stream at random
        starts drawn from `gen` (on the tokens' device)."""
        idx = torch.randint(0, toks.shape[0] - seq - 1, (cohorts, batch),
                            generator=gen, device=toks.device)
        pos = idx[..., None] + torch.arange(seq, device=toks.device)
        return {"tokens": toks[pos]}
    return make_batch


def _flat_batch(gen, toks, batch, seq):
    """(batch, seq) windows of the token stream at random starts drawn
    from `gen`."""
    idx = torch.randint(0, toks.shape[0] - seq - 1, (batch,), generator=gen,
                        device=toks.device)
    return {"tokens": toks[idx[:, None] + torch.arange(seq,
                                                        device=toks.device)]}


def _mask_plan(name, *, force_lam=None, mask_mode=None):
    """Mask-training plan: cohort-axis state, fused train step, bitpacked
    round; `mask_mode="threshold"` is the FedMask variant."""
    def plan(model_api, scfg: steplib.StepConfig, *, gen, cohorts,
             spec=None, optimizer="momentum", codec=None) -> LaunchPlan:
        if force_lam is not None:
            scfg = dataclasses.replace(scfg, lam=force_lam)
        if mask_mode is not None:
            scfg = dataclasses.replace(scfg, mask_mode=mask_mode)
        spec = masking.MaskSpec() if spec is None else spec
        state = steplib.init_fed_state(gen, model_api, spec, C=cohorts,
                                       optimizer=optimizer)
        return LaunchPlan(
            name=name, state=state,
            step_fn=steplib.make_train_step(model_api, scfg),
            round_fn=steplib.make_round_step(model_api, scfg, codec=codec),
            make_batch=_cohort_batch(cohorts))
    return plan


# per-algorithm StepConfig overrides (the reference's plans.MASK_ALGOS)
MASK_ALGOS = {
    "fedpm_reg": {},
    "fedpm": {"lam": 0.0},
    "fedmask": {"lam": 0.0, "mask_mode": "threshold"},
}

def _fedavg_plan(model_api, scfg: steplib.StepConfig, *, gen, cohorts,
                 spec=None, optimizer="momentum", codec=None) -> LaunchPlan:
    return LaunchPlan(
        name="fedavg", state=steplib.init_fedavg_state(gen, model_api),
        step_fn=steplib.make_fedavg_step(model_api, scfg), round_fn=None,
        make_batch=_flat_batch)


for _name, _kw in MASK_ALGOS.items():
    registry.register_launch(_name, _mask_plan(
        _name, force_lam=_kw.get("lam"), mask_mode=_kw.get("mask_mode")))
registry.register_launch("fedavg", _fedavg_plan)
