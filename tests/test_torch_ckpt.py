"""The port's step checkpoints and state bundles against the JAX package
(`repro.ckpt.checkpoint`): what either package writes, the other reads
into equal arrays (bfloat16, None leaves, uint32 words, the int32 step,
named-tuple paths, the manifest and LATEST); the reference's robustness
cases on the port; and the asynchronous save's copy-before-return, which
the port's in-place train step needs.  Integers and bit patterns are
compared exactly."""
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro.core import federated as jfederated

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import federated
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

BF = np.linspace(-3, 3, 12).astype(ml_dtypes.bfloat16).reshape(3, 4)
F32 = np.arange(10, dtype=np.float32) / 7
WORDS = np.asarray([0, 1, 0xFFFFFFFF, 0x80000000, 12345], np.uint32)


def _jax_tree():
    """A fed-state-like tree as the reference holds it."""
    return {"scores": {"w": jnp.asarray(F32.reshape(2, 5)), "none": None},
            "floats": {"norm": jnp.asarray(BF)},
            "words": [jnp.asarray(WORDS)],
            "step": jnp.asarray(40, jnp.int32)}


def _torch_tree():
    """The same tree as the port holds it: words int32-stored, step an
    int."""
    return {"scores": {"w": torch.from_numpy(F32.reshape(2, 5).copy()),
                       "none": None},
            "floats": {"norm": torch.from_numpy(
                BF.view(np.int16).copy()).view(torch.bfloat16)},
            "words": [torch.from_numpy(WORDS.view(np.int32).copy())],
            "step": 40}


def _np(t):
    """A port tensor as the reference's numpy array (bf16 via its bits,
    int32-stored words as uint32)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def test_jax_checkpoint_reads_in_the_port(tmp_path):
    d = str(tmp_path)
    jckpt.save_checkpoint(d, 7, _jax_tree(), extra={"note": 1})
    assert ckpt.latest_step(d) == 7
    raw, manifest = ckpt.load_raw(d)
    jraw, jmanifest = jckpt.load_raw(d)
    assert manifest == jmanifest
    assert sorted(raw) == sorted(jraw)
    for k, v in jraw.items():
        if v is None:
            assert raw[k] is None
            continue
        got = _np(raw[k])
        if v.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.dtype == v.dtype and got.shape == v.shape, k
        assert got.tobytes() == v.tobytes(), k
    like = _torch_tree()
    state, step = ckpt.restore_checkpoint(d, like)
    assert step == 7 and state["step"] == 40 and state["scores"]["none"] \
        is None
    assert state["floats"]["norm"].dtype == torch.bfloat16
    for k in ("scores/w", "floats/norm", "words/0"):
        got, want = ckpt._flatten(state)[k], ckpt._flatten(like)[k]
        assert torch.equal(got.view(torch.uint8) if got.dtype ==
                           torch.bfloat16 else got,
                           want.view(torch.uint8) if want.dtype ==
                           torch.bfloat16 else want), k


def test_port_checkpoint_reads_in_jax(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 9, _torch_tree(), extra={"ledger": {"rounds": 2}})
    with open(os.path.join(d, "LATEST")) as f:
        assert f.read() == "9"
    manifest = json.load(open(os.path.join(d, "manifest_9.json")))
    jmanifest_dir = str(tmp_path / "j")
    jckpt.save_checkpoint(jmanifest_dir, 9, _jax_tree(),
                          extra={"ledger": {"rounds": 2}})
    assert manifest == json.load(open(os.path.join(jmanifest_dir,
                                                   "manifest_9.json")))
    raw, _ = jckpt.load_raw(d)
    want, _ = jckpt.load_raw(jmanifest_dir)
    for k, v in want.items():
        if v is None:
            assert raw[k] is None
            continue
        assert raw[k].dtype == v.dtype and raw[k].shape == v.shape, k
        assert raw[k].tobytes() == v.tobytes(), k
    restored, step = jckpt.restore_checkpoint(d, _jax_tree())
    assert step == 9 and int(restored["step"]) == 40
    assert np.asarray(restored["step"]).dtype == np.int32


def test_named_tuple_paths_cross_both_ways(tmp_path):
    """A ServerState's paths are the reference's (".theta/..."), so a
    server checkpoint crosses between the packages."""
    d = str(tmp_path)
    theta = {"w": np.full((2, 3), 0.25, np.float32)}
    jstate = jfederated.ServerState(
        theta={"w": jnp.asarray(theta["w"])}, floats={"b": None},
        weights={"w": jnp.ones((2, 3), jnp.bfloat16)},
        seed=jnp.uint32(3), round=jnp.int32(5))
    jckpt.save_checkpoint(d, 1, jstate)
    like = federated.ServerState(
        theta={"w": torch.zeros(2, 3)}, floats={"b": None},
        weights={"w": torch.zeros(2, 3, dtype=torch.bfloat16)},
        seed=0, round=0)
    state, _ = ckpt.restore_checkpoint(d, like)
    assert torch.equal(state.theta["w"], torch.from_numpy(theta["w"]))
    assert state.seed == 3 and state.round == 5
    assert torch.equal(state.weights["w"].float(), torch.ones(2, 3))
    ckpt.save_checkpoint(str(tmp_path / "p"), 2, state)
    back, _ = jckpt.restore_checkpoint(str(tmp_path / "p"), jstate)
    np.testing.assert_array_equal(np.asarray(back.theta["w"]), theta["w"])
    assert int(back.round) == 5


def test_bundles_cross_both_ways(tmp_path):
    jarrays = {"state/0": WORDS, "state/1": None,
               "buf0/w": jnp.asarray(np.asarray([1.5, -2.5],
                                                ml_dtypes.bfloat16)),
               "pend0/s0": F32}
    extra = {"tick": 7, "totals": {"commits": 2, "bits": 123.5}}
    p = str(tmp_path / "sub" / "jbundle")
    jckpt.save_bundle(p, jarrays, extra)
    assert ckpt.bundle_exists(p)
    got, gextra = ckpt.load_bundle(p)
    assert gextra == extra
    assert torch.equal(got["state/0"], torch.from_numpy(WORDS.view(np.int32)))
    assert got["state/1"] is None
    assert got["buf0/w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["buf0/w"].view(torch.int16).numpy().view(np.uint16),
        np.asarray([1.5, -2.5], ml_dtypes.bfloat16).view(np.uint16))
    assert torch.equal(got["pend0/s0"], torch.from_numpy(F32))
    q = str(tmp_path / "sub" / "pbundle")
    assert not ckpt.bundle_exists(q)
    ckpt.save_bundle(q, got, extra)
    back, bextra = jckpt.load_bundle(q)
    want, _ = jckpt.load_bundle(p)
    assert bextra == extra and sorted(back) == sorted(want)
    for k, v in want.items():
        if v is None:
            assert back[k] is None
            continue
        assert back[k].dtype == v.dtype
        assert back[k].tobytes() == v.tobytes(), k
    assert not [f for f in os.listdir(tmp_path / "sub") if ".tmp" in f]


def test_leftover_tmp_files_never_shadow_a_checkpoint(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(6.0), "b": None}
    ckpt.save_checkpoint(d, 2, tree)
    for name in (".tmp_step_3.npz", ".tmp_manifest.json", ".tmp_latest"):
        with open(os.path.join(d, name), "wb") as f:
            f.write(b"\x00garbage")
    assert ckpt.latest_step(d) == 2
    restored, step = ckpt.restore_checkpoint(d, tree)
    assert step == 2 and torch.equal(restored["a"], torch.arange(6.0))


def test_async_checkpointer_gc_removes_manifests_too(tmp_path):
    d = str(tmp_path)
    ac = ckpt.AsyncCheckpointer(d, keep=2)
    for s in range(5):
        ac.save(s, {"a": torch.full((3,), float(s))})
    ac.close()
    steps = sorted(int(f[5:-4]) for f in os.listdir(d)
                   if f.startswith("step_"))
    manifests = sorted(int(f[9:-5]) for f in os.listdir(d)
                       if f.startswith("manifest_"))
    assert steps == manifests == [3, 4]
    restored, step = ckpt.restore_checkpoint(d, {"a": torch.zeros(3)})
    assert step == 4 and float(restored["a"][0]) == 4.0


def test_async_checkpointer_surfaces_worker_errors(tmp_path):
    blocker = str(tmp_path / "not_a_dir")
    with open(blocker, "w") as f:
        f.write("a file where a directory must go")
    ac = ckpt.AsyncCheckpointer(blocker, keep=2)
    ac.save(0, {"a": torch.ones(2)})
    with pytest.raises(OSError):
        ac.wait()
    with pytest.raises(OSError):
        ac.save(1, {"a": torch.ones(2)})


def test_restore_raises_on_missing_and_mismatched_leaves(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, {"scores": {"w": torch.ones(4, 3)}})
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore_checkpoint(d, {"scores": {"w": torch.ones(4, 3),
                                               "extra": torch.ones(2)}})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(d, {"scores": {"w": torch.ones(2, 3)}})


def test_async_save_copies_before_it_returns(tmp_path):
    """The port's train step updates scores and momentum in place right
    after a round's save: the checkpoint must hold the values at save
    time, and the worker must never read the live tensors."""
    d = str(tmp_path)
    s = torch.arange(1 << 16, dtype=torch.float32)
    state = {"scores": s, "step": 3}
    ac = ckpt.AsyncCheckpointer(d, keep=2)
    ac.save(3, state)
    s.add_(1.0)                 # the next step's in-place update
    state["step"] = 4
    ac.close()
    raw, manifest = ckpt.load_raw(d)
    assert manifest["step"] == 3 and int(raw["step"]) == 3
    assert torch.equal(raw["scores"],
                       torch.arange(1 << 16, dtype=torch.float32))
