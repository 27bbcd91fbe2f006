"""String-keyed registries (`repro.api.registry`).

The host-sim algorithms:

    from repro_torch import api
    algo = api.get_algorithm("fedpm_reg", apply_fn, loss_fn,
                             spec=masking.MaskSpec(), lam=1.0)
    state = algo.init(generator, params_like)
    state, metrics = algo.round(state, data, participation, sizes,
                                generator)

Factories have the uniform signature `factory(apply_fn, loss_fn, *,
spec=None, **hyperparams) -> FedAlgorithm`, and accept `codec=` (an
`api.codecs` name or instance).  `api.algorithms` registers them on
import.

The launch plans: `repro_torch.launch.plans` registers the pod-scale
mask-training plans under the same names on import, and
`repro_torch.launch.train --algo <name>` resolves through
`get_launch_plan`, so neither has per-algorithm dispatch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict


@dataclasses.dataclass(frozen=True)
class AlgorithmEntry:
    name: str
    factory: Callable          # host-sim FedAlgorithm factory
    payload_spec: object       # api.protocol.PayloadSpec
    description: str = ""


_REGISTRY: Dict[str, AlgorithmEntry] = {}
_LAUNCH: Dict[str, Callable] = {}


def register(name: str, *, payload_spec, description: str = ""):
    """Decorator: register a host-sim algorithm factory under `name`."""
    def deco(factory: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"algorithm {name!r} already registered")
        _REGISTRY[name] = AlgorithmEntry(name, factory, payload_spec,
                                         description)
        return factory
    return deco


def get_entry(name: str) -> AlgorithmEntry:
    if name not in _REGISTRY:
        raise KeyError(f"unknown algorithm {name!r}; available: "
                       f"{', '.join(available())}")
    return _REGISTRY[name]


def get_algorithm(name: str, apply_fn: Callable, loss_fn: Callable,
                  **kwargs):
    """The named algorithm for a model (`apply_fn`, `loss_fn`); kwargs are
    its hyperparameters (`spec`, `lam`, `lr`, ...)."""
    return get_entry(name).factory(apply_fn, loss_fn, **kwargs)


def available() -> tuple:
    return tuple(sorted(_REGISTRY))


def register_launch(name: str, plan_factory: Callable) -> None:
    if name in _LAUNCH:
        raise ValueError(f"launch plan {name!r} already registered")
    _LAUNCH[name] = plan_factory


def get_launch_plan(name: str) -> Callable:
    if name not in _LAUNCH:
        raise KeyError(f"algorithm {name!r} has no launch plan "
                       f"(launchable: {', '.join(launchable()) or 'none'}; "
                       f"import repro_torch.launch.plans to populate)")
    return _LAUNCH[name]


def launchable() -> tuple:
    return tuple(sorted(_LAUNCH))
