"""The server's state and the deployable artifact (part of
`repro.core.federated`; the host-simulated rounds are not ported yet).

The artifact is the paper's end product, "seed + binary mask": the seed
that regenerates the frozen random weights and one bitpacked mask per
masked leaf, about n/8 bytes in all, plus the float leaves.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.api import payloads
from repro_torch.core import masking
from repro_torch.core import tree as tu

Pytree = Any


class ServerState(NamedTuple):
    theta: Pytree      # global probability mask (None at float leaves)
    floats: Pytree     # averaged float leaves (None at masked leaves)
    weights: Pytree    # frozen random weights (regenerable from seed)
    seed: int          # the init seed (the only weight payload), uint32
    round: int


def init_server(gen: torch.Generator, params_like: Pytree,
                spec: masking.MaskSpec) -> ServerState:
    """Server state on `gen`'s device: frozen weights and initial scores
    drawn from `gen`, theta = sigmoid(scores), the float leaves copied.
    The seed is `gen`'s initial seed, which regenerates the weights from
    a fresh generator."""
    mp = masking.init_masked(gen, params_like, spec)
    theta = tu.tree_map(
        lambda s: None if s is None else torch.sigmoid(s.float()), mp.scores)
    floats = tu.tree_map(lambda f: None if f is None else f.clone(),
                         mp.floats)
    return ServerState(theta=theta, floats=floats, weights=mp.weights,
                       seed=gen.initial_seed() & 0xFFFFFFFF, round=0)


def final_artifact(server: ServerState,
                   generator: Optional[torch.Generator] = None,
                   u: Optional[list] = None) -> dict:
    """The deployable artifact {"seed", "masks": {path: (words, shape)},
    "floats"}: a mask drawn from theta (uniforms from `generator`, or
    injected as `u`, one tensor per masked leaf in flatten order), packed
    leaf by leaf (one pack launch per masked leaf on the card)."""
    scores = masking.scores_from_theta(server.theta)
    mask = masking.final_mask(
        masking.MaskedParams(server.weights, scores, server.floats),
        generator, u)
    payload = payloads.BitpackedMasks.from_masks(mask, server.floats)
    return {"seed": server.seed, "masks": payload.as_path_dict(),
            "floats": server.floats}
