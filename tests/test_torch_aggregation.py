"""The rest of the port's `core/aggregation.py`, `payloads.
mean_from_counts`, `SignVotes` and `FloatDeltas` against the JAX package
on the same numpy inputs: the host folds over client lists, the
staleness weights, the count folds and their fixed-width records, the
CRC32 and the uplink accounting.

Tolerances: counts, words, CRCs, `pack_counts` streams and bit counts
are equal; f32 means of {0,1} masks under f32 weights are summed client
by client in the reference's order and are equal; a float tree cast
back to bf16 is equal; the staleness discount (1 + s)^-alpha is exactly
1.0 at s = 0 and within one f32 ulp elsewhere (torch's and XLA's pow may
part by one), and the weights normalized from it within 2 ulp."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import payloads as jpayloads
from repro.core import aggregation as jagg

from repro_torch.api import payloads
from repro_torch.core import aggregation as agg
from repro_torch.core import tree as tu
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

K = 4


def _masks(seed=0):
    rng = np.random.default_rng(seed)
    return [{"a": (rng.random((5, 7)) < 0.4).astype(np.uint8), "b": None,
             "c": (rng.random((33,)) < 0.7).astype(np.uint8)}
            for _ in range(K)]


def _t(tree):
    return tu.tree_map(lambda v: None if v is None else
                       torch.from_numpy(np.array(v)), tree)


def _j(tree):
    return jax.tree_util.tree_map(lambda v: None if v is None else
                                  jnp.asarray(v), tree,
                                  is_leaf=lambda x: x is None)


def _equal_trees(t, j):
    lt = tu.leaves(t)
    lj = jax.tree_util.tree_leaves(j, is_leaf=lambda x: x is None)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        if a is None:
            assert b is None
            continue
        b = np.asarray(b)
        assert str(a.dtype).split(".")[1] == b.dtype.name
        assert a.float().numpy().tobytes() == \
            b.astype(np.float32).tobytes()


@pytest.mark.parametrize("weights", (None, [3.0, 1.0, 2.0, 5.0]))
def test_aggregate_masks_and_bayesian_match_jax(weights):
    ms = _masks()
    _equal_trees(agg.aggregate_masks([_t(m) for m in ms], weights),
                 jagg.aggregate_masks([_j(m) for m in ms], weights))
    _equal_trees(agg.aggregate_bayesian([_t(m) for m in ms], 1.0, 2.0),
                 jagg.aggregate_bayesian([_j(m) for m in ms], 1.0, 2.0))


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_aggregate_floats_matches_jax(dtype):
    rng = np.random.default_rng(1)
    trees = [{"w": rng.standard_normal((4, 6)).astype(np.float32), "n": None}
             for _ in range(K)]
    tt = [tu.tree_map(lambda v: None if v is None else
                      torch.from_numpy(v).to(getattr(torch, dtype)), t)
          for t in trees]
    jt = [jax.tree_util.tree_map(lambda v: jnp.asarray(v, dtype), t)
          for t in trees]
    w = [1.0, 2.0, 3.0, 4.0]
    _equal_trees(agg.aggregate_floats(tt, w), jagg.aggregate_floats(jt, w))


def test_staleness_weight_and_weights():
    s = np.array([0, 1, 2, 5, 0, 10], np.float32)
    for alpha in (0.5, 1.0, 2.0):
        got = agg.staleness_weight(torch.from_numpy(s), alpha)
        want = np.asarray(jagg.staleness_weight(jnp.asarray(s), alpha))
        assert got.dtype == torch.float32
        assert np.all(got.numpy()[s == 0] == 1.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -23, atol=0)
        npw = agg.staleness_weight(s, alpha)
        assert npw.dtype == np.float32 and np.all(npw[s == 0] == 1.0)
        assert agg.staleness_weight(0, alpha) == 1.0
        assert agg.staleness_weight(3, alpha) == jagg.staleness_weight(
            3, alpha)
        sizes = np.array([10, 20, 30, 40, 50, 60], np.float32)
        gw = agg.staleness_weights(sizes, s, alpha).numpy()
        jw = np.asarray(jagg.staleness_weights(sizes, s, alpha))
        np.testing.assert_allclose(gw, jw, rtol=2 ** -22, atol=0)
    # all fresh: exactly the synchronous round's weights
    sizes = torch.tensor([3.0, 1.0, 4.0])
    fresh = agg.staleness_weights(sizes, [0, 0, 0])
    assert torch.equal(fresh, sizes / sizes.sum())


def _words(seed=2, rows=3, n=100):
    rng = np.random.default_rng(seed)
    bits = (rng.random((rows, n)) < 0.5).astype(np.uint8)
    bits[0, :32] = 1     # a word with its sign bit set
    return np.stack([np.asarray(jagg.pack_bits(jnp.asarray(np.concatenate(
        [b, np.zeros((-n) % 32, np.uint8)])))) for b in bits])


def test_fold_popcount_and_bit_counts_match_jax():
    w = _words()
    tw = torch.from_numpy(w.view(np.int32).copy())
    assert agg.fold_popcount(5, tw[0]) == jagg.fold_popcount(5, w[0])
    assert agg.fold_popcount(0, w[1]) == jagg.fold_popcount(0, w[1])
    acc0 = np.arange(32 * w.shape[1], dtype=np.int32)
    for words in (tw[0], tw):
        got = agg.fold_bit_counts(torch.from_numpy(acc0), words)
        want = np.asarray(jagg.fold_bit_counts(
            jnp.asarray(acc0), words.numpy().view(np.uint32)))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # any grouping of the clients gives the same counts
    one_by_one = torch.zeros(32 * w.shape[1], dtype=torch.int32)
    for r in tw:
        one_by_one = agg.fold_bit_counts(one_by_one, r)
    assert torch.equal(one_by_one, agg.fold_bit_counts(
        torch.zeros_like(one_by_one), tw))


@pytest.mark.parametrize("acc_bits", (8, 16, 32))
def test_pack_counts_streams_match_jax(acc_bits):
    rng = np.random.default_rng(acc_bits)
    top = min(2 ** acc_bits - 1, 10 ** 6)
    for n in (0, 1, 3, 101):
        c = rng.integers(0, top + 1, n)
        got = agg.pack_counts(torch.from_numpy(c), acc_bits)
        want = jagg.pack_counts(c, acc_bits)
        assert got.dtype == np.uint32 and np.array_equal(got, want)
        assert got.size * 32 == agg.packed_count_bits(n, acc_bits) == \
            jagg.packed_count_bits(n, acc_bits)
        back = agg.unpack_counts(got, n, acc_bits)
        assert back.dtype == np.int64 and np.array_equal(back, c)
        assert np.array_equal(back, jagg.unpack_counts(want, n, acc_bits))


@pytest.mark.parametrize("acc_bits", (8, 16))
def test_pack_counts_raises_on_overflow(acc_bits):
    c = np.array([1, 2 ** acc_bits], np.int64)
    with pytest.raises(OverflowError):
        agg.pack_counts(c, acc_bits)
    with pytest.raises(OverflowError):
        jagg.pack_counts(c, acc_bits)
    with pytest.raises(OverflowError):
        agg.pack_counts(torch.tensor([-1, 0]), acc_bits)
    with pytest.raises(ValueError):
        agg.pack_counts(np.zeros(3), 12)


def test_words_checksum_and_uplink_bits_match_jax():
    w = _words()
    arrays = [w[0], w[1][:2], np.zeros(0, np.uint32)]
    want = jagg.words_checksum(arrays)
    assert agg.words_checksum(arrays) == want
    assert agg.words_checksum([torch.from_numpy(a.view(np.int32).copy())
                               for a in arrays]) == want
    m = _masks()[0]
    for packed in (True, False):
        assert agg.uplink_bits(_t(m), packed) == jagg.uplink_bits(
            _j(m), packed)


def test_mean_from_counts_matches_jax_and_the_words_mean():
    """The pooled-counts mean equals the reference's, and, with dyadic
    weights, the flat words mean over the same clients."""
    w = _words(rows=4, n=70)
    tw = torch.from_numpy(w.view(np.int32).copy())
    counts = np.stack([np.asarray(jagg.fold_bit_counts(
        jnp.zeros(32 * w.shape[1], jnp.int32), w[:2])), np.asarray(
        jagg.fold_bit_counts(jnp.zeros(32 * w.shape[1], jnp.int32), w[2:]))])
    cw = np.array([0.25, 0.25], np.float32)
    got = payloads.mean_from_counts(torch.from_numpy(counts), 70,
                                    torch.from_numpy(cw))
    want = np.asarray(jpayloads.mean_from_counts(jnp.asarray(counts), 70,
                                                 jnp.asarray(cw)))
    assert got.numpy().tobytes() == want.tobytes()
    flat = payloads.mean_from_words(tw, 70, torch.full((4,), 0.25))
    assert torch.equal(got, flat)


def test_sign_votes_match_jax():
    """`from_signs` packs s > 0 (a zero sign goes out as -1), `to_signs`
    unpacks +-1, 1 Bpp (0 with no parameters); the stacked votes'
    batched mean is the share of +1 votes."""
    rng = np.random.default_rng(5)
    signs = [{"w": np.sign(rng.standard_normal((6, 11))).astype(np.float32),
              "x": None, "z": np.array([0.0, 1.0, -1.0], np.float32)}
             for _ in range(3)]
    tp = [payloads.SignVotes.from_signs(_t(s)) for s in signs]
    jp = [japi.SignVotes.from_signs(_j(s)) for s in signs]
    for a, b in zip(tp, jp):
        assert a.shapes == b.shapes and a.wire_bits() == b.wire_bits()
        assert a.num_params() == b.num_params() == 69
        for x, y in zip([w for w in tu.leaves(a.words) if w is not None],
                        jax.tree_util.tree_leaves(b.words)):
            assert np.array_equal(x.numpy().view(np.uint32), np.asarray(y))
        _equal_trees(a.to_signs(), b.to_signs())
        assert float(a.bpp()) == float(b.bpp()) == 1.0
    assert tp[0].to_signs()["z"].tolist() == [-1.0, 1.0, -1.0]
    assert float(payloads.SignVotes.from_signs({"e": None}).bpp()) == 0.0
    st = payloads.stack_payloads(tp)
    assert st.words["w"].shape == (3, 3) and st.shapes == tp[0].shapes
    wn = torch.tensor([0.5, 0.25, 0.25])
    q = payloads.batched_packed_mean(st, wn)["w"]
    want = sum(float(w) * (torch.from_numpy(s["w"]) > 0).float()
               for w, s in zip(wn, signs))
    assert torch.allclose(q, want)
    s1 = payloads.slice_payload(st, 1)
    assert torch.equal(s1.words["w"], tp[1].words["w"])


def test_float_deltas_match_jax():
    vals = {"a": np.ones((3, 4), np.float32), "b": None,
            "c": np.zeros((5,), np.float32)}
    tv = _t(vals)
    tv["c"] = tv["c"].to(torch.bfloat16)
    jv = _j(vals)
    jv["c"] = jv["c"].astype(jnp.bfloat16)
    a, b = payloads.FloatDeltas.from_tree(tv), japi.FloatDeltas.from_tree(jv)
    assert (a.shapes, a.bits) == (b.shapes, b.bits) == (((3, 4), (5,)),
                                                        (32, 16))
    assert a.num_params() == b.num_params() and a.wire_bits() == \
        b.wire_bits()
    assert float(a.bpp()) == float(b.bpp())
    assert float(payloads.FloatDeltas.from_tree({}).bpp()) == 0.0
    st = payloads.stack_payloads([a, a])
    assert st.values["a"].shape == (2, 3, 4) and st.bits == a.bits
