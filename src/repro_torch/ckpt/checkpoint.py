"""The deployable artifact on disk (part of `repro.ckpt.checkpoint`; the
step checkpoints and bundles are not ported yet).

The layout is the reference's, so one file loads in either package:
`<path>` is an npz holding `seed` (uint32), `mask|<leaf path>` word
vectors as uint32 and `float|<leaf path>` float leaves (bfloat16 ones as
their uint16 bit patterns), with '/' in leaf paths written as '|';
`<path>.json` holds {"shapes": {path: shape}, "bf16_floats": [path]}.
No `ml_dtypes` is needed: bfloat16 crosses as its bits and is restored
with `Tensor.view(torch.bfloat16)`.

`artifact_masks` and `served_params` turn a loaded artifact into the
params tree a server decodes with, as examples/serve_masked.py does.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.api import payloads
from repro_torch.core import tree as tu

Pytree = Any


def _flatten(tree: Pytree) -> dict:
    """{path: leaf} with None leaves, paths '/'-joined as the reference
    writes them."""
    return dict(tu.flatten_with_paths(tree))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_artifact(path: str, artifact: dict) -> int:
    """Write an artifact of `federated.final_artifact` (atomically, the
    npz last renamed into place); returns the npz's bytes."""
    arrays = {"seed": np.asarray(int(artifact["seed"]) & 0xFFFFFFFF,
                                 dtype=np.uint32)}
    shapes = {}
    for k, (words, shape) in artifact["masks"].items():
        arrays["mask|" + k.replace("/", "|")] = \
            words.detach().cpu().numpy().view(np.uint32)
        shapes[k] = list(shape)
    bf16 = []
    for k, v in _flatten(artifact["floats"]).items():
        if v is None:
            continue
        if v.dtype == torch.bfloat16:
            bf16.append(k)
        arrays["float|" + k.replace("/", "|")] = _to_numpy(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    with open(path + ".json", "w") as f:
        json.dump({"shapes": shapes, "bf16_floats": bf16}, f)
    return os.path.getsize(path)


def load_artifact(path: str, device="cuda") -> dict:
    """{"seed": int, "masks": {path: (int32 words, shape)}, "floats":
    {path: tensor}} on `device`, from a file either package wrote.  The
    card by default, where the masks unpack on the kernels; pass
    device="cpu" for the plain versions.  Raises if the card is asked
    for and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_artifact: device 'cuda' requested but no "
                           "CUDA device is available (pass device='cpu')")
    data = np.load(path)
    with open(path + ".json") as f:
        meta = json.load(f)
    shapes = meta.get("shapes", meta)
    bf16 = set(meta.get("bf16_floats", []))
    masks, floats = {}, {}
    for k in data.files:
        if k.startswith("mask|"):
            key = k[5:].replace("|", "/")
            words = torch.from_numpy(data[k].astype(np.uint32).view(
                np.int32))
            masks[key] = (words.to(device), tuple(shapes[key]))
        elif k.startswith("float|"):
            key = k[6:].replace("|", "/")
            a = data[k]
            if key in bf16:
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            floats[key] = t.to(device)
    return {"seed": int(data["seed"]), "masks": masks, "floats": floats}


def artifact_masks(artifact: dict) -> tuple:
    """(masks {path: uint8 mask}, BitpackedMasks) of a loaded artifact;
    the masks unpack on the artifact's device (one unpack launch per
    masked leaf on the card)."""
    packed = payloads.BitpackedMasks.from_path_dict(artifact["masks"],
                                                    artifact["floats"])
    return packed.to_masks(), packed


def served_params(weights: Pytree, masks: dict, floats: dict) -> Pytree:
    """The params tree a server decodes with, as examples/serve_masked.py
    builds it: m * w at every masked leaf of `weights` (regenerated from
    the artifact's seed), the artifact's float leaf everywhere else."""
    flat, tdef = tu.flatten(weights)
    paths = [p for p, _ in tu.flatten_with_paths(weights)]
    return tu.unflatten(tdef, [
        floats[p] if w is None else masks[p].to(w.dtype) * w
        for p, w in zip(paths, flat)])
