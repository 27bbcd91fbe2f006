"""Fault-tolerant checkpoints, state bundles and the deployable artifact
(`repro.ckpt.checkpoint`).

The on-disk formats are the reference's, so either package reads what
the other writes:

* a step checkpoint is `step_<s>.npz` (one `.npy` entry a leaf, keyed
  by its tree path with '/' written as '|') beside
  `manifest_<s>.json` = {"step", "keys", "extra", "dtypes"}; `LATEST`
  names the newest.  Each file is written under a tmp name and
  `os.replace`d into place, the npz first, then the manifest, then
  `LATEST`, so a crash mid-write never shadows a complete checkpoint;
* a bundle is `<path>.npz` + `<path>.json` = {"extra", "dtypes"} (the
  buffered-async engine's persistence), the manifest last;
* bfloat16 leaves are stored as their uint16 bit patterns and named in
  "dtypes"; a None leaf is the "__none__" string sentinel; the port's
  int32-stored packed words are stored as uint32 (the reference's
  dtype); a Python int leaf (the fed state's `step`) as a 0-d int32
  array (int64 past 32 bits).

Tree paths are the reference's: a dict key, a list or tuple index, and
a named tuple's field as ".<name>" (`jax.tree_util`'s `GetAttrKey`).

Reading needs no `ml_dtypes`: `load_raw` and `load_bundle` return CPU
tensors (bfloat16 restored with `Tensor.view`, uint32 as int32-stored
words), `restore_checkpoint` puts each leaf on the device of the
template's matching leaf, and a template's int leaf comes back an int.
A checkpoint streams leaf by leaf in both directions (host memory holds
one leaf at a time); `AsyncCheckpointer.save` copies the whole state to
the host before it returns, because the port's train step updates the
state's tensors in place, and its thread writes only host arrays.

`artifact_masks` and `served_params` turn a loaded artifact into the
params tree a server decodes with, as examples/serve_masked.py does.
"""
from __future__ import annotations

import json
import math
import os
import queue
import struct
import threading
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.api import payloads
from repro_torch.core import tree as tu

Pytree = Any

_SENTINEL = "__none__"


# ---------------------------------------------------------------------------
# Tree paths and host conversion
# ---------------------------------------------------------------------------


def _path_items(tree, prefix: str = "") -> list:
    """[(path, leaf)] in flatten order with the reference's path keys."""
    join = lambda k: f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _path_items(tree[k], join(k))]
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return [pl for f, v in zip(tree._fields, tree)
                for pl in _path_items(v, join("." + f))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _path_items(v, join(i))]
    return [(prefix, tree)]


def _flatten(tree: Pytree) -> dict:
    """{path: leaf}, None leaves included."""
    return dict(_path_items(tree))


def _to_numpy(v) -> np.ndarray:
    """A leaf as the host array the reference would write: bfloat16 as
    uint16 bits, int32-stored words as uint32, a Python int as int32
    (int64 past 32 bits).  A CPU tensor's array shares its memory."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        if t.dtype == torch.int32:
            return t.numpy().view(np.uint32)
        return t.numpy()
    if isinstance(v, int):
        return np.asarray(v, np.int32 if -2**31 <= v < 2**31 else np.int64)
    return np.asarray(v)


def _to_tensor(a: np.ndarray, bf16: bool) -> torch.Tensor:
    """A stored array as a CPU tensor: bfloat16 from its bits, uint32 as
    int32-stored words."""
    a = np.asarray(a, order="C")   # (ascontiguousarray makes 0-d 1-d)
    if bf16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32))
    return torch.from_numpy(a)


def _like(got: torch.Tensor, like):
    """A loaded tensor in the form of the template's leaf: on its device,
    or an int where the template holds one."""
    if isinstance(like, torch.Tensor):
        return got.to(like.device)
    if isinstance(like, int):
        return int(got)
    return got


def _is_none_entry(a: np.ndarray, bf16: bool) -> bool:
    return a.dtype.kind in ("U", "V") and not bf16


def _write_npz(path: str, arrays):
    """np.savez's layout (uncompressed zip of `<key>.npy`), written one
    array at a time from an iterable of (key, array)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for k, a in arrays:
            with zf.open(k + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(a),
                                          allow_pickle=False)


def _write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _entries(tree: Pytree, manifest: dict):
    """(npz key, host array) per leaf; fills the manifest's keys and
    dtypes as it goes."""
    for k, v in _flatten(tree).items():
        manifest["keys"].append(k)
        if v is None:
            yield k.replace("/", "|"), np.asarray(_SENTINEL)
            continue
        if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            manifest["dtypes"][k] = "bfloat16"
        yield k.replace("/", "|"), _to_numpy(v)


# ---------------------------------------------------------------------------
# Step checkpoints
# ---------------------------------------------------------------------------


def save_checkpoint(ckpt_dir: str, step: int, tree: Pytree,
                    extra: Optional[dict] = None) -> str:
    """Write `tree` as step `step` (atomically; npz, manifest, LATEST in
    that order); returns the npz's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    manifest = {"step": int(step), "keys": [], "extra": extra or {},
                "dtypes": {}}
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}.npz")
    final = os.path.join(ckpt_dir, f"step_{step}.npz")
    _write_npz(tmp, _entries(tree, manifest))
    os.replace(tmp, final)
    mtmp = os.path.join(ckpt_dir, ".tmp_manifest.json")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(ckpt_dir, f"manifest_{step}.json"))
    # the "latest" pointer last: readers trust only complete checkpoints
    ltmp = os.path.join(ckpt_dir, ".tmp_latest")
    with open(ltmp, "w") as f:
        f.write(str(step))
    os.replace(ltmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def read_manifest(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The manifest of checkpoint `step` (by default the latest)."""
    if step is None:
        step = latest_step(ckpt_dir)
    with open(os.path.join(ckpt_dir, f"manifest_{step}.json")) as f:
        return json.load(f)


def _open(ckpt_dir: str, step: Optional[int]):
    """(the npz file, its manifest) of `step`, by default the latest."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    data = np.load(os.path.join(ckpt_dir, f"step_{step}.npz"),
                   allow_pickle=False)
    return data, read_manifest(ckpt_dir, step)


def _read_header(f) -> tuple:
    """(shape, fortran_order, dtype) of the .npy header at f's position."""
    major, _ = np.lib.format.read_magic(f)
    read = (np.lib.format.read_array_header_1_0 if major == 1
            else np.lib.format.read_array_header_2_0)
    return read(f)


def _read_entry(data, nk: str) -> np.ndarray:
    """An npz entry's array.  An uncompressed entry (np.savez's and this
    module's) is read straight from the file at its offset, one read,
    without zipfile's chunked copy and CRC pass."""
    info = data.zip.getinfo(nk + ".npy")
    if info.compress_type != zipfile.ZIP_STORED:
        return data[nk]
    with open(data.zip.filename, "rb") as f:
        f.seek(info.header_offset)
        name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
        f.seek(info.header_offset + 30 + name_len + extra_len)
        shape, fortran, dtype = _read_header(f)
        a = np.fromfile(f, dtype=dtype, count=math.prod(shape))
    return a.reshape(shape, order="F" if fortran else "C")


def _load_all(data, bf16_keys) -> dict:
    out = {}
    for nk in data.files:
        k = nk.replace("|", "/")
        a = _read_entry(data, nk)
        out[k] = (None if _is_none_entry(a, k in bf16_keys)
                  else _to_tensor(a, k in bf16_keys))
    return out


def load_raw(ckpt_dir: str, step: Optional[int] = None
             ) -> tuple[dict, dict]:
    """One checkpoint's leaves without a structure template:
    ({path: CPU tensor | None}, manifest), the host-side view
    `runtime.elastic` matches against its own state."""
    data, manifest = _open(ckpt_dir, step)
    with data:
        return _load_all(data, set(manifest.get("dtypes", {}))), manifest


def _stored_header(data, nk: str) -> tuple:
    """(shape, dtype) of an npz entry from its .npy header, reading no
    data."""
    with data.zip.open(nk + ".npy") as f:
        shape, _, dtype = _read_header(f)
    return tuple(shape), dtype


def restore_checkpoint(ckpt_dir: str, tree_like: Pytree,
                       step: Optional[int] = None) -> tuple[Pytree, int]:
    """Restore into the structure of `tree_like`: each leaf on the device
    of the template's matching leaf (an int where it holds an int).
    Raises KeyError for a leaf the checkpoint lacks and ValueError for a
    shape that differs (the launcher's cue for `restore_theta_only`)."""
    data, manifest = _open(ckpt_dir, step)
    with data:
        flat_like = _path_items(tree_like)
        names = {nk.replace("|", "/"): nk for nk in data.files}
        bf16_keys = set(manifest.get("dtypes", {}))
        for k, leaf in flat_like:
            if k not in names:
                raise KeyError(f"checkpoint missing leaf {k}")
            if leaf is not None and hasattr(leaf, "shape"):
                got, dtype = _stored_header(data, names[k])
                if got != tuple(leaf.shape) and not (
                        dtype.kind in ("U", "V") and k not in bf16_keys):
                    raise ValueError(
                        f"checkpoint leaf {k} has shape {got}, expected "
                        f"{tuple(leaf.shape)}")
        leaves = []
        for k, leaf in flat_like:
            a = _read_entry(data, names[k])
            bf16 = k in bf16_keys
            leaves.append(None if _is_none_entry(a, bf16)
                          else _like(_to_tensor(a, bf16), leaf))
            del a
    _, treedef = tu.flatten(tree_like)
    return tu.unflatten(treedef, leaves), int(manifest["step"])


class AsyncCheckpointer:
    """Background-thread checkpointer.  `save` copies the state to host
    arrays before it returns (the caller may then update its tensors in
    place) and queues the write; `wait` drains; a failed write raises on
    the next `save` or `wait`.  Keeps the newest `keep` checkpoints."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: queue.Queue = queue.Queue()
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree, extra = item
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree, extra)
                self._gc()
            except BaseException as e:  # surfaced on the next save/wait
                self._err = e
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(
            int(f[5:-4]) for f in os.listdir(self.ckpt_dir)
            if f.startswith("step_") and f.endswith(".npz"))
        for s in steps[:-self.keep]:
            for name in (f"step_{s}.npz", f"manifest_{s}.json"):
                try:
                    os.remove(os.path.join(self.ckpt_dir, name))
                except OSError:
                    pass

    def save(self, step: int, tree: Pytree, extra: Optional[dict] = None):
        if self._err:
            raise self._err
        host = tu.tree_map(_host_tree_leaf, tree)
        self._q.put((int(step), host, extra))

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._t.join()


def _host_tree_leaf(v):
    """A leaf as an owned host value the worker may write: tensors become
    CPU tensors (bfloat16 kept, for the manifest), ints stay ints."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        return t.clone() if t.device.type == "cpu" else t.cpu()
    return v


# ---------------------------------------------------------------------------
# Atomic state bundles: flat {key: array} + JSON extra, one file pair.
# The buffered-async engine persists its buffer, in-flight messages and
# counters through these.
# ---------------------------------------------------------------------------


def save_bundle(path: str, arrays: dict, extra: Optional[dict] = None
                ) -> str:
    """Atomically write a flat {key: tensor | array | int | None} dict and
    a JSON-serializable `extra` to `path`.npz / `path`.json (the manifest
    last)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    manifest = {"keys": [], "dtypes": {}}
    tmp = path + ".tmp.npz"
    _write_npz(tmp, _entries(dict(arrays), manifest))
    os.replace(tmp, path + ".npz")
    # manifest LAST: readers trust only bundles with a manifest
    _write_json(path + ".json", {"extra": extra or {},
                                 "dtypes": manifest["dtypes"]})
    return path + ".npz"


def load_bundle(path: str) -> tuple[dict, dict]:
    """Inverse of `save_bundle`: ({key: CPU tensor | None}, extra)."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    with np.load(path + ".npz", allow_pickle=False) as data:
        out = _load_all(data, set(manifest.get("dtypes", {})))
    return out, manifest.get("extra", {})


def bundle_exists(path: str) -> bool:
    return os.path.exists(path + ".json") and os.path.exists(
        path + ".npz")


# ---------------------------------------------------------------------------
# The deployable artifact: (seed, bitpacked masks, float leaves)
# ---------------------------------------------------------------------------


def save_artifact(path: str, artifact: dict) -> int:
    """Write an artifact of `federated.final_artifact`: `<path>` is an npz
    of `seed` (uint32), `mask|<leaf path>` uint32 word vectors and
    `float|<leaf path>` float leaves (bfloat16 as uint16 bits);
    `<path>.json` holds {"shapes", "bf16_floats"}.  Returns the npz's
    bytes."""
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
            floats[key] = _to_tensor(data[k], key in bf16).to(device)
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
