"""Launch-plan registry: algorithm name -> plan factory.

`repro_torch.launch.plans` registers the mask-training plans on import;
`repro_torch.launch.train --algo <name>` resolves through here, so the
launcher has no per-algorithm dispatch.
"""
from __future__ import annotations

from typing import Callable, Dict

_LAUNCH: Dict[str, Callable] = {}


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
