"""The port's deployable artifact ("seed + binary mask") against the JAX
package: `federated.final_artifact` with the reference's uniforms
injected, the file layout of `ckpt.save_artifact` / `load_artifact` in
both directions (bfloat16 floats included), and `BitpackedMasks`'
bits per parameter.  Words and masks are integers: equal, no tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import payloads as jpayloads
from repro.core import aggregation as jaggregation
from repro.ckpt import checkpoint as jcheckpoint
from repro.configs import get_config as jget_config
from repro.core import federated as jfederated
from repro.core import masking as jmasking
from repro.models import build_model as jbuild_model

from repro_torch import convert
from repro_torch.api import payloads
from repro_torch.ckpt import checkpoint
from repro_torch.configs import get_config
from repro_torch.core import aggregation, federated, masking, tree
from repro_torch.models import build_model
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ULP = 2.0 ** -23        # float32 ulp just below 1.0
_NONE = lambda x: x is None


def _np(t):
    return jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), t, is_leaf=_NONE)


@functools.lru_cache(maxsize=None)
def _jax_artifact(arch="internlm2-1.8b"):
    """The reference's server, its artifact under key 9, and the uniforms
    `final_mask` drew (one per leaf of the flattened scores, None leaves
    counted, as it splits its key)."""
    japi = jbuild_model(jget_config(arch, smoke=True))
    key = jax.random.PRNGKey(4)
    server = jax.jit(lambda k: jfederated.init_server(
        k, japi.init_params(k), jmasking.MaskSpec()))(key)
    akey = jax.random.PRNGKey(9)
    art = jfederated.final_artifact(server, akey)
    flat = jax.tree_util.tree_leaves(server.theta, is_leaf=_NONE)
    keys = jax.random.split(akey, len(flat))
    u = [np.array(jax.random.uniform(k, t.shape, dtype=jnp.float32))
         for t, k in zip(flat, keys) if t is not None]
    return server, art, u


def _port_artifact():
    server, _, u = _jax_artifact()
    tserver = convert.server_from_jax(_np(server), "cpu")
    return tserver, federated.final_artifact(
        tserver, u=[torch.from_numpy(a) for a in u])


def test_final_artifact_words_match_jax():
    """The same server and uniforms give the reference's paths, shapes,
    seed and words (as uint32), and its float leaves."""
    server, art, _ = _jax_artifact()
    tserver, tart = _port_artifact()
    assert tart["seed"] == int(np.asarray(art["seed"]))
    assert list(tart["masks"]) == list(art["masks"])
    for path, (words, shape) in tart["masks"].items():
        jwords, jshape = art["masks"][path]
        assert tuple(shape) == tuple(jshape)
        assert words.dtype == torch.int32
        assert np.array_equal(words.numpy().view(np.uint32),
                              np.asarray(jwords))
    jf = [np.asarray(x) for x in jax.tree_util.tree_leaves(art["floats"])]
    tf = [x for x in tree.leaves(tart["floats"]) if x is not None]
    assert len(jf) == len(tf) > 0
    for a, b in zip(jf, tf):
        assert np.array_equal(b.float().numpy(), a.astype(np.float32))


def test_init_server_layout():
    """The port's own server: theta = sigmoid(scores) of the masked
    leaves, the float leaves copied, the generator's seed kept."""
    api = build_model(get_config("internlm2-1.8b", smoke=True))
    gen = torch.Generator().manual_seed(1234)
    server = federated.init_server(gen, api.init_params(gen),
                                   masking.MaskSpec())
    assert server.seed == 1234 and server.round == 0
    thetas = [t for t in tree.leaves(server.theta) if t is not None]
    assert thetas and all(t.dtype == torch.float32 and 0 < t.min()
                          and t.max() < 1 for t in thetas)
    for t, f in zip(tree.leaves(server.theta), tree.leaves(server.floats)):
        assert (t is None) != (f is None)


def test_port_file_loads_in_jax(tmp_path):
    """A file the port writes loads through `repro.ckpt.load_artifact`:
    the same seed, words (uint32) and floats (bf16 by their bits)."""
    _, tart = _port_artifact()
    path = str(tmp_path / "port.npz")
    nbytes = checkpoint.save_artifact(path, tart)
    assert nbytes > 0
    got = jcheckpoint.load_artifact(path)
    assert int(got["seed"]) == tart["seed"]
    assert set(got["masks"]) == set(tart["masks"])
    for path_, (words, shape) in tart["masks"].items():
        jwords, jshape = got["masks"][path_]
        assert jwords.dtype == np.uint32 and jshape == tuple(shape)
        assert np.array_equal(jwords, words.numpy().view(np.uint32))
    flat = dict(tree.flatten_with_paths(tart["floats"]))
    bf16 = [k for k, v in flat.items()
            if v is not None and v.dtype == torch.bfloat16]
    assert bf16, "the SMOKE floats hold the bf16 embedding"
    for k, v in flat.items():
        if v is None:
            continue
        a = got["floats"][k]
        assert a.dtype.name == str(v.dtype).split(".")[1]
        assert np.array_equal(np.asarray(a, np.float32), v.float().numpy())


def test_jax_file_loads_in_port(tmp_path):
    """A file the reference writes loads in the port on the CPU: int32
    words of the same uint32 bits, bf16 floats restored from their bits,
    and the masks unpack to the reference's."""
    _, art, _ = _jax_artifact()
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save_artifact(path, art)
    got = checkpoint.load_artifact(path, device="cpu")
    assert got["seed"] == int(np.asarray(art["seed"]))
    for k, (jwords, jshape) in art["masks"].items():
        words, shape = got["masks"][k]
        assert words.dtype == torch.int32 and shape == tuple(jshape)
        assert np.array_equal(words.numpy().view(np.uint32),
                              np.asarray(jwords))
        n = int(np.prod(shape))
        assert np.array_equal(
            aggregation.unpack_bits(words, n).numpy(),
            np.asarray(jaggregation.unpack_bits(jwords, n)))
    for k, a in jcheckpoint._flatten(art["floats"]).items():
        if a is None:
            continue
        t = got["floats"][k]
        assert str(t.dtype).split(".")[1] == np.asarray(a).dtype.name
        assert np.array_equal(t.float().numpy(),
                              np.asarray(a).astype(np.float32))


def test_artifact_round_trip_in_port(tmp_path):
    """save -> load -> unpack gives back `final_mask` bit for bit, and the
    packed masks take n/8 bytes up to a word per leaf."""
    tserver, tart = _port_artifact()
    _, _, u = _jax_artifact()
    scores = masking.scores_from_theta(tserver.theta)
    mask = masking.final_mask(masking.MaskedParams(
        tserver.weights, scores, tserver.floats),
        u=[torch.from_numpy(a) for a in u])
    path = str(tmp_path / "a.npz")
    checkpoint.save_artifact(path, tart)
    got = checkpoint.load_artifact(path, device="cpu")
    want = dict(masking.leaves_with_paths(mask))
    n = 0
    for k, (words, shape) in got["masks"].items():
        m = aggregation.unpack_bits(
            words, int(np.prod(shape))).reshape(shape)
        assert torch.equal(m, want[k])
        n += m.numel()
    packed = sum(4 * w.numel() for w, _ in got["masks"].values())
    assert n / 8 <= packed <= n / 8 + 4 * len(got["masks"])


def test_served_params_match_reference(tmp_path):
    """A file the reference writes, loaded and unpacked in the port
    (`artifact_masks`) and applied to the converted weights
    (`served_params`), gives the m * w and float leaves that
    examples/serve_masked.py builds, exactly; the loaded
    `BitpackedMasks` has the reference's bpp up to the log2 ulp."""
    server, art, _ = _jax_artifact()
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save_artifact(path, art)
    loaded = checkpoint.load_artifact(path, device="cpu")
    masks, packed = checkpoint.artifact_masks(loaded)
    tserver = convert.server_from_jax(_np(server), "cpu")
    got = dict(tree.flatten_with_paths(checkpoint.served_params(
        tserver.weights, masks, loaded["floats"])))
    jart = jcheckpoint.load_artifact(path)
    want, jmasks = {}, {}
    for k, w in jcheckpoint._flatten(server.weights).items():
        if w is None:
            want[k] = np.asarray(jart["floats"][k], np.float32)
            continue
        words, shape = jart["masks"][k]
        jmasks[k] = jaggregation.unpack_bits(
            jnp.asarray(words), int(np.prod(shape))).reshape(shape)
        want[k] = np.asarray(jmasks[k].astype(w.dtype) * w, np.float32)
    assert set(got) == set(want) and jmasks
    for k, v in got.items():
        assert np.array_equal(v.float().numpy(), want[k]), k
    assert packed.num_params() == sum(int(m.size) for m in jmasks.values())
    jbpp = jpayloads.BitpackedMasks.from_masks(jmasks).bpp()
    assert abs(float(packed.bpp()) - float(jbpp)) <= ULP


def test_bitpacked_masks_match_jax():
    """from_masks / to_masks / num_params / wire_bits / as_path_dict
    equal the reference's; bpp is the entropy of the same popcount share
    and may differ by the log2 ulp (ROADMAP Queue 3)."""
    rng = np.random.default_rng(0)
    masks = {"a": {"w_x": (rng.random((3, 40)) < 0.3).astype(np.uint8),
                   "scale": None},
             "b": [(rng.random((7, 5, 9)) < 0.8).astype(np.uint8), None]}
    jm = jax.tree_util.tree_map(
        lambda x: None if x is None else jnp.asarray(x), masks,
        is_leaf=_NONE)
    tm = tree.tree_map(lambda x: None if x is None else torch.from_numpy(x),
                       masks)
    jp = jpayloads.BitpackedMasks.from_masks(jm)
    tp = payloads.BitpackedMasks.from_masks(tm)
    assert tp.shapes == jp.shapes
    assert tp.num_params() == jp.num_params()
    assert tp.wire_bits() == jp.wire_bits()
    assert abs(float(tp.bpp()) - float(jp.bpp())) <= ULP
    jd, td = jp.as_path_dict(), tp.as_path_dict()
    assert list(td) == list(jd) == ["a/w_x", "b/0"]
    for k in jd:
        assert td[k][1] == jd[k][1]
        assert np.array_equal(td[k][0].numpy().view(np.uint32),
                              np.asarray(jd[k][0]))
    back = tp.to_masks()
    for a, b in zip(tree.leaves(back), tree.leaves(tm)):
        assert (a is None and b is None) or torch.equal(a, b)


def test_load_artifact_defaults_to_the_card(tmp_path, monkeypatch):
    """Without `device`, `load_artifact` puts the artifact on the card:
    where there is none it raises rather than hand back CPU tensors (the
    plain versions run only when the caller asks for the CPU)."""
    _, tart = _port_artifact()
    path = str(tmp_path / "a.npz")
    checkpoint.save_artifact(path, tart)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.load_artifact(path)
    got = checkpoint.load_artifact(path, device="cpu")
    assert all(w.device.type == "cpu" for w, _ in got["masks"].values())
