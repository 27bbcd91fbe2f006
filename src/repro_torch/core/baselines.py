"""The baselines the paper compares against (Sec. IV), by their legacy
names (`repro.core.baselines`).  The implementations live in
`api.algorithms`, where every algorithm implements the `FedAlgorithm`
protocol; prefer resolving by name:

    from repro_torch import api
    algo = api.get_algorithm("topk", apply_fn, loss_fn, spec=spec,
                             k_frac=0.3)
    state = algo.init(generator, params_like)
    state, metrics = algo.round(state, data, part, sizes, generator)

`metrics["uplink_bpp"]` comes from the transport layer: 32 for
`FloatDeltas` (FedAvg), exactly 1 for `SignVotes` (MV-SignSGD), the
empirical bit entropy (<= 1) for `BitpackedMasks` (FedPM, FedMask,
Top-k).
"""
from __future__ import annotations

from repro_torch import api as _api
from repro_torch.api.protocol import FedAlgorithm as Algorithm  # noqa: F401
from repro_torch.core import masking


def fedavg(apply_fn, loss_fn, lr=0.05, local_steps=3) -> Algorithm:
    return _api.get_algorithm("fedavg", apply_fn, loss_fn, lr=lr,
                              local_steps=local_steps)


def mv_signsgd(apply_fn, loss_fn, lr=1e-3, local_steps=3) -> Algorithm:
    return _api.get_algorithm("mv_signsgd", apply_fn, loss_fn, lr=lr,
                              local_steps=local_steps)


def topk_mask(apply_fn, loss_fn, spec: masking.MaskSpec, k_frac=0.3,
              lr=0.1, local_steps=3) -> Algorithm:
    return _api.get_algorithm("topk", apply_fn, loss_fn, spec=spec,
                              k_frac=k_frac, lr=lr, local_steps=local_steps)


def fedmask(apply_fn, loss_fn, spec: masking.MaskSpec, tau=0.5, lr=0.1,
            local_steps=3) -> Algorithm:
    return _api.get_algorithm("fedmask", apply_fn, loss_fn, spec=spec,
                              tau=tau, lr=lr, local_steps=local_steps)
