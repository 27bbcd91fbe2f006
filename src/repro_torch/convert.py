"""Carry state from the JAX package into the port.

The JAX package's arrays are handed over as numpy arrays (bfloat16
arrays as numpy's ml_dtypes bfloat16) in the same nested-dict structure,
None leaves included, so both packages then compute on identical state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import tree as tu


def to_torch(a, device):
    """One numpy array (or None) -> an owned torch tensor on `device`."""
    if a is None:
        return None
    a = np.array(a)  # an owned, writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def tree_to_torch(tree, device):
    return tu.tree_map(lambda a: to_torch(a, device), tree)


def state_from_jax(np_state: dict, device) -> dict:
    """The JAX `init_fed_state` dict (scores / floats / weights / opt_m
    [/ opt_v] / step, leaves as numpy arrays) -> the port's fed state."""
    state = {k: tree_to_torch(v, device) for k, v in np_state.items()
             if k != "step"}
    state["step"] = int(np.asarray(np_state["step"]))
    return state


def fedavg_state_from_jax(np_state: dict, device) -> dict:
    """The JAX `init_fedavg_state` dict (params / opt_m / step, leaves as
    numpy arrays) -> the port's fedavg state."""
    return {"params": tree_to_torch(np_state["params"], device),
            "opt_m": tree_to_torch(np_state["opt_m"], device),
            "step": int(np.asarray(np_state["step"]))}


def server_from_jax(np_server, device):
    """A JAX `ServerState` (theta / floats / weights trees with numpy
    leaves, seed, round) -> the port's `federated.ServerState`."""
    from repro_torch.core.federated import ServerState
    return ServerState(theta=tree_to_torch(np_server.theta, device),
                       floats=tree_to_torch(np_server.floats, device),
                       weights=tree_to_torch(np_server.weights, device),
                       seed=int(np.asarray(np_server.seed)) & 0xFFFFFFFF,
                       round=int(np.asarray(np_server.round)))


def masked_params_from_jax(np_mp, device):
    """A JAX `MaskedParams` (weights / scores / floats trees with numpy
    leaves, the CNNs' nested "convs"/"denses" lists included) -> the
    port's `masking.MaskedParams`."""
    from repro_torch.core.masking import MaskedParams
    return MaskedParams(tree_to_torch(np_mp.weights, device),
                        tree_to_torch(np_mp.scores, device),
                        tree_to_torch(np_mp.floats, device))


def mask_state_from_jax(np_state, device):
    """A JAX fedmask `MaskState` (scores / floats / weights, round) -> the
    port's `api.algorithms.MaskState`."""
    from repro_torch.api.algorithms import MaskState
    return MaskState(tree_to_torch(np_state.scores, device),
                     tree_to_torch(np_state.floats, device),
                     tree_to_torch(np_state.weights, device),
                     int(np.asarray(np_state.round)))


def float_state_from_jax(np_state, device):
    """A JAX mv_signsgd / fedavg `FloatState` (params, round) -> the
    port's `api.algorithms.FloatState`."""
    from repro_torch.api.algorithms import FloatState
    return FloatState(tree_to_torch(np_state.params, device),
                      int(np.asarray(np_state.round)))
