"""The port's wire codecs (`repro_torch.api.codecs`) against the JAX
package, case for case as `tests/test_codecs.py` holds the reference,
on the same numpy masks, signs and floats: every codec's `WireMessage`
words, float sidecar and CRC32 checksum equal the reference's, round
trips are lossless, the meters equal the wire, `GolombRice`'s
packed-domain meter equals the reference's (also across its chunks),
and a flipped bit raises `ChecksumError`.

Tolerances: every integer (words, checksums, bit counts) is equal.  The
port's arithmetic meter evaluates the encoder's own host formula, so it
equals the port's wire exactly; against the reference's traced meter it
is within one word (XLA's and numpy's f32 log2 may part by an ulp at a
ceiling).  Bpp ratios of the round engine agree to 1e-6 (f32 weights)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import codecs as jcodecs
from repro.core import aggregation as jaggregation

from repro_torch import api
from repro_torch.api import codecs
from repro_torch.api.protocol import PayloadSpec
from repro_torch.core import masking
from repro_torch.core import tree as tu
from repro_torch.data import partition, synthetic
from repro_torch.models import cnn
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

PACKED = ("bitpack", "golomb", "arithmetic")
EXACT_MEASURE = ("bitpack", "golomb", "signpack", "float32")
ALL = PACKED + ("signpack", "float32")


def _t(tree):
    return {k: None if v is None else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _j(tree):
    return {k: None if v is None else jnp.asarray(v) for k, v in tree.items()}


def _masks(p=0.12, sizes=((5, 37), (501,), (64,)), seed=0):
    rng = np.random.default_rng(seed)
    mask = {f"m{i}": (rng.random(sh) < p).astype(np.uint8)
            for i, sh in enumerate(sizes)}
    mask["skip"] = None
    return mask


def _mask_pair(p=0.12, sizes=((5, 37), (501,), (64,)), floats=True,
               seed=0):
    """(port payload, reference payload) of the same masks and floats."""
    mask = _masks(p, sizes, seed)
    fl = {k: None for k in mask}
    fl["skip"] = np.linspace(0.0, 1.0, 7, dtype=np.float32) \
        if floats else None
    return (api.BitpackedMasks.from_masks(_t(mask), _t(fl)),
            japi.BitpackedMasks.from_masks(_j(mask), _j(fl)))


def _sign_pair(n=130, seed=0):
    s = np.where(np.random.default_rng(seed).random(n) < 0.5, 1.0,
                 -1.0).astype(np.float32)
    signs = {"w": s, "b": None}
    return (api.SignVotes.from_signs(_t(signs)),
            japi.SignVotes.from_signs(_j(signs)))


def _float_pair():
    vals = {"x": np.random.default_rng(1).standard_normal((33, 3)).astype(
        np.float32), "y": None, "z": np.asarray([1.5], np.float32)}
    return (api.FloatDeltas.from_tree(_t(vals)),
            japi.FloatDeltas.from_tree(_j(vals)))


def _same_message(tmsg, jmsg):
    assert tmsg.codec == jmsg.codec
    assert len(tmsg.words) == len(jmsg.words)
    for a, b in zip(tmsg.words, jmsg.words):
        assert a.dtype == np.uint32 and np.array_equal(a, np.asarray(b))
    assert len(tmsg.sidecar) == len(jmsg.sidecar)
    for a, b in zip(tmsg.sidecar, jmsg.sidecar):
        assert np.array_equal(a, np.asarray(b))
    assert tmsg.checksum == jmsg.checksum
    assert (tmsg.wire_bits, tmsg.sidecar_bits, tmsg.header_bits,
            tmsg.total_bits) == (jmsg.wire_bits, jmsg.sidecar_bits,
                                 jmsg.header_bits, jmsg.total_bits)


def _tree_equal(a, b):
    la, lb = tu.leaves(a), tu.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x is None:
            assert y is None
            continue
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("name", PACKED)
def test_mask_roundtrip_exact(name):
    tp, jp = _mask_pair()
    codec = codecs.get_codec(name)
    msg = codec.encode(tp)
    _same_message(msg, jcodecs.get_codec(name).encode(jp))
    back = codec.decode(msg)
    assert type(back) is api.BitpackedMasks
    _tree_equal(back.words, tp.words)
    _tree_equal(back.to_masks(), tp.to_masks())
    _tree_equal(back.floats, tp.floats)
    assert back.shapes == tp.shapes
    assert msg.wire_bits == sum(w.size for w in msg.words) * 32
    assert msg.sidecar_bits == sum(w.size for w in msg.sidecar) * 32


@pytest.mark.parametrize("name", PACKED + ("signpack",))
def test_sign_roundtrip_exact(name):
    tp, jp = _sign_pair()
    codec = codecs.get_codec(name)
    msg = codec.encode(tp)
    _same_message(msg, jcodecs.get_codec(name).encode(jp))
    back = codec.decode(msg)
    assert type(back) is api.SignVotes
    _tree_equal(back.to_signs(), tp.to_signs())
    assert np.array_equal(back.to_signs()["w"].numpy(),
                          np.asarray(jp.to_signs()["w"]))


def test_float_roundtrip_exact():
    tp, jp = _float_pair()
    codec = codecs.get_codec("float32")
    msg = codec.encode(tp)
    _same_message(msg, jcodecs.get_codec("float32").encode(jp))
    back = codec.decode(msg)
    _tree_equal(back.values, tp.values)
    assert back.bits == tp.bits and back.shapes == tp.shapes


def test_bf16_floats_serialize_as_the_reference_does():
    """A bf16 leaf (the CNN's weights) goes on the wire as its raw 2-byte
    words, padded to a whole word: the reference's bytes."""
    x = np.random.default_rng(2).standard_normal((5, 3)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tmsg = codecs.get_codec("float32").encode(
        api.FloatDeltas.from_tree({"w": tx}))
    jmsg = jcodecs.get_codec("float32").encode(
        japi.FloatDeltas.from_tree({"w": jx}))
    _same_message(tmsg, jmsg)
    back = codecs.get_codec("float32").decode(tmsg)
    assert back.bits == (16,) and torch.equal(back.values["w"], tx)


@pytest.mark.parametrize("name", PACKED)
@pytest.mark.parametrize("p", (0.02, 0.12, 0.5, 0.9))
def test_measure_matches_encode(name, p):
    """measure_bits is encode's size: exactly the port's wire for every
    codec; against the reference's meter exactly, but within one word
    for the arithmetic coder."""
    tp, jp = _mask_pair(p=p, seed=int(p * 100))
    codec = codecs.get_codec(name)
    measured = codec.measure_bits(tp)
    wire = codec.encode(tp).wire_bits
    assert measured == wire, (name, p)
    want = int(jcodecs.get_codec(name).measure_bits(jp))
    if name in EXACT_MEASURE:
        assert measured == want
    else:
        assert abs(measured - want) <= 32


def test_codec_registry_and_defaults():
    assert set(codecs.available()) == {"bitpack", "golomb", "arithmetic",
                                       "signpack", "float32"}
    assert codecs.available() == jcodecs.available()
    with pytest.raises(KeyError, match="bitpack"):
        codecs.get_codec("nope")
    spec = PayloadSpec(api.BitpackedMasks, None)
    with pytest.raises(ValueError, match="float32"):
        codecs.resolve("float32", spec)
    assert codecs.resolve(None, spec).name == "arithmetic"
    assert codecs.resolve(None, PayloadSpec(api.FloatDeltas, 32.0)
                          ).name == "float32"
    assert codecs.resolve(None, PayloadSpec(api.SignVotes, 1.0)
                          ).name == "signpack"
    for cls, jcls in ((api.BitpackedMasks, japi.BitpackedMasks),
                      (api.SignVotes, japi.SignVotes),
                      (api.FloatDeltas, japi.FloatDeltas)):
        assert codecs.default_for(cls) == jcodecs.default_for(jcls)
        assert sorted(n for n in codecs.available()
                      if codecs.get_codec(n).accepts(cls)) == sorted(
            n for n in jcodecs.available()
            if jcodecs.get_codec(n).accepts(jcls))
    c = codecs.get_codec("golomb")
    assert codecs.resolve(c, spec) is c


def test_arithmetic_sub_1bpp_at_low_probability():
    """Mean mask probability ~0.12: the arithmetic coder is below 1 Bpp,
    at least the eq. 13 bound and within 10% of it; Bitpack32 is the
    word-aligned 1 Bpp; golomb also wins."""
    tp, jp = _mask_pair(p=0.12, sizes=((128, 64), (96, 96), (777,)))
    n = tp.num_params()
    bound = float(tp.bpp())
    assert bound < 1.0 and abs(bound - float(jp.bpp())) <= 1e-6
    arith = codecs.get_codec("arithmetic")
    meas = arith.measure_bits(tp)
    assert bound <= meas / n < 1.0 and meas / n <= 1.10 * bound
    assert arith.encode(tp).wire_bits == meas
    assert codecs.get_codec("bitpack").measure_bits(tp) == \
        ((n + 31) // 32) * 32
    assert codecs.get_codec("golomb").measure_bits(tp) < n


# ---------------------------------------------------------------------------
# The round engine
# ---------------------------------------------------------------------------


CFG = cnn.ConvConfig("c", (16, 16), (64,), n_classes=4, img_size=8)
K, H = 2, 1


@pytest.fixture(scope="module")
def setup():
    gen = torch.Generator().manual_seed(0)
    task = synthetic.make_image_task(gen, n=96, img=8, n_classes=4,
                                     noise=0.3)
    params = cnn.init_params(gen, CFG)
    cidx = partition.partition_iid(np.random.default_rng(0),
                                   task.y.numpy(), K)
    data = synthetic.federated_batches(gen, task, cidx, K, H, 8)
    sizes = torch.tensor([len(c) for c in cidx], dtype=torch.float32)
    return dict(params=params, data=data, sizes=sizes,
                apply_fn=lambda p, b: cnn.forward(p, CFG, b["images"]),
                loss_fn=cnn.ce_loss)


def _low_theta_state(algo, params, p=0.12):
    st = algo.init(torch.Generator().manual_seed(1), params)
    return st._replace(theta=tu.tree_map(
        lambda t: None if t is None else torch.full_like(t, p), st.theta))


def test_fedpm_reg_round_sub_1bpp_measured(setup):
    """A fedpm_reg round at mean mask probability ~0.12: the arithmetic
    uplink measures below 1 Bpp and within 10% of the entropy bound; the
    bitpack codec on the same round measures the word-aligned 1 Bpp."""
    part = torch.ones(K, dtype=torch.bool)
    common = dict(spec=masking.MaskSpec(), local_steps=H, lr=0.0,
                  float_lr=0.0, optimizer="sgd", lam=1.0)
    algo = api.get_algorithm("fedpm_reg", setup["apply_fn"],
                             setup["loss_fn"], **common)
    st = _low_theta_state(algo, setup["params"])
    _, m = algo.round(st, setup["data"], part, setup["sizes"],
                      torch.Generator().manual_seed(2))
    bound, meas = float(m["uplink_bpp"]), float(m["uplink_bpp_measured"])
    assert bound < 1.0 and meas < 1.0
    assert 0.90 * bound <= meas <= 1.10 * bound
    algo_bp = api.get_algorithm("fedpm_reg", setup["apply_fn"],
                                setup["loss_fn"], codec="bitpack", **common)
    st = _low_theta_state(algo_bp, setup["params"])
    n = sum(l.numel() for l in tu.leaves(st.theta) if l is not None)
    _, mb = algo_bp.round(st, setup["data"], part, setup["sizes"],
                          torch.Generator().manual_seed(2))
    assert float(mb["uplink_bpp_measured"]) == pytest.approx(
        (((n + 31) // 32) * 32) / n)


@pytest.mark.parametrize("name", ["fedpm_reg", "fedpm", "fedmask", "topk",
                                  "mv_signsgd", "fedavg"])
def test_round_metrics_complete_for_every_algorithm(setup, name):
    """run_round reports every uplink and downlink meter for every
    registered algorithm, and the measured uplink bits are what the
    codec's encoder puts on the wire for each client's payload."""
    algo = api.get_algorithm(name, setup["apply_fn"], setup["loss_fn"],
                             spec=masking.MaskSpec(), local_steps=H)
    st = algo.init(torch.Generator().manual_seed(0), setup["params"])
    sent = []
    client = algo.client_update
    algo.client_update = lambda *a: (lambda out: sent.append(out[0])
                                     or out)(client(*a))
    _, m = algo.round(st, setup["data"], torch.ones(K, dtype=torch.bool),
                      setup["sizes"], torch.Generator().manual_seed(3))
    for k in ("uplink_bpp", "uplink_bpp_measured", "uplink_bits_measured",
              "downlink_bpp", "downlink_bits"):
        assert k in m and np.isfinite(float(m[k])), (name, k)
    assert float(m["downlink_bits"]) > 0
    wire = sum(algo.codec.encode(p).wire_bits + algo.codec.sidecar_bits(p)
               for p in sent)
    assert float(m["uplink_bits_measured"]) == float(np.float32(wire)) > 0
    if name in ("fedpm_reg", "fedpm"):
        assert 8.0 <= float(m["downlink_bpp"]) < 8.1
    if name == "fedavg":
        assert float(m["uplink_bpp_measured"]) == 32.0
    if name == "mv_signsgd":
        assert float(m["uplink_bpp"]) == 1.0


def test_prob_broadcast_wire_and_dequantize():
    theta = {"a": torch.tensor([[0.1, 0.5], [0.9, 0.0]]), "b": None}
    floats = {"a": None, "b": torch.ones(3)}
    pay = api.ProbBroadcast.from_theta(
        theta, torch.Generator().manual_seed(0), bits=8, floats=floats)
    assert pay.num_params() == 4
    assert pay.wire_bits() == 32
    assert pay.sidecar_bits() == 96
    back = pay.to_theta()["a"]
    assert float((back - theta["a"]).abs().max()) <= 1.0 / 255 + 1e-6
    assert float(pay.bpp()) == pytest.approx(8.0)


def test_comm_ledger_accumulates_both_directions():
    led = api.CommLedger()
    led.update({"uplink_bits_measured": 8e6, "downlink_bits": 16e6,
                "root_bits_measured": 4e6})
    led.update({"uplink_bits_measured": 8e6})
    assert led.rounds == 2
    assert led.uplink_mb == pytest.approx(2.0)
    assert led.downlink_mb == pytest.approx(2.0)
    assert led.root_mb == pytest.approx(0.5)
    d = led.as_dict()
    assert d["cumulative_total_mb"] == pytest.approx(4.0)
    assert sorted(d) == sorted(japi.CommLedger().as_dict())


# ---------------------------------------------------------------------------
# Degenerate payloads: empty streams, all-zeros and all-ones rows
# ---------------------------------------------------------------------------


def _degenerate_pair(kind):
    n = 677   # odd: the sub-word tail
    vals = {"empty": np.zeros((0,), np.uint8),
            "zeros": np.zeros((n,), np.uint8),
            "ones": np.ones((n,), np.uint8)}[kind]
    return (api.BitpackedMasks.from_masks(_t({"m0": vals}), {"m0": None}),
            japi.BitpackedMasks.from_masks(_j({"m0": vals}), {"m0": None}))


@pytest.mark.parametrize("name", ("golomb", "arithmetic"))
@pytest.mark.parametrize("kind", ("empty", "zeros", "ones"))
def test_degenerate_mask_rows_roundtrip(name, kind):
    tp, jp = _degenerate_pair(kind)
    codec = codecs.get_codec(name)
    msg = codec.encode(tp)
    _same_message(msg, jcodecs.get_codec(name).encode(jp))
    back = codec.decode(msg)
    assert type(back) is api.BitpackedMasks and back.shapes == tp.shapes
    _tree_equal(back.words, tp.words)
    if kind == "empty":
        assert back.num_params() == 0


@pytest.mark.parametrize("name", ("golomb", "arithmetic"))
@pytest.mark.parametrize("kind", ("empty", "zeros", "ones"))
def test_degenerate_measure_matches_wire(name, kind):
    tp, jp = _degenerate_pair(kind)
    codec = codecs.get_codec(name)
    msg = codec.encode(tp)
    measured = codec.measure_bits(tp)
    assert msg.wire_bits == measured
    want = int(jcodecs.get_codec(name).measure_bits(jp))
    assert abs(measured - want) <= (0 if name in EXACT_MEASURE else 32)
    if kind == "empty":
        return
    if name == "arithmetic" or kind == "zeros":
        assert msg.wire_bits < 677
    else:
        assert msg.wire_bits <= 2 * 677


# ---------------------------------------------------------------------------
# Packed-domain meters
# ---------------------------------------------------------------------------


def _pooled(n, p, seed):
    bits = (np.random.default_rng(seed).random(n) < p).astype(np.uint8)
    padded = np.concatenate([bits, np.zeros(((-n) % 32,), np.uint8)])
    words = np.asarray(jaggregation.pack_bits(jnp.asarray(padded))) \
        if padded.size else np.zeros((0,), np.uint32)
    return bits, words


@pytest.mark.parametrize("name", ("bitpack", "golomb"))
@pytest.mark.parametrize("n,p", ((1000, 0.03), (1024, 0.5), (64, 0.0),
                                 (33, 1.0), (7, 0.3), (4096, 0.001)))
def test_measure_pooled_words_matches_unpacked_meter(name, n, p):
    """The packed-domain meter agrees with the unpacked meter, with the
    serialized size and with the reference's meter, bit for bit."""
    codec = codecs.get_codec(name)
    bits, words = _pooled(n, p, n)
    tw = torch.from_numpy(words.view(np.int32).copy())
    via_words = codec.measure_pooled_words(tw, n)
    assert via_words == codec.measure_pooled_bits(torch.from_numpy(bits))
    assert via_words == int(jcodecs.get_codec(name).measure_pooled_words(
        jnp.asarray(words), n))
    payload = api.BitpackedMasks.from_masks({"m": torch.from_numpy(bits)},
                                            {"m": None})
    assert via_words == codec.encode(payload).wire_bits


@pytest.mark.parametrize("chunk", (None, 1, 3))
@pytest.mark.parametrize("n", (0, 1, 31, 32, 33, 1000))
@pytest.mark.parametrize("p", (0.0, 0.01, 0.5, 1.0))
def test_golomb_pooled_words_equals_jax(monkeypatch, chunk, n, p):
    """`GolombRice.measure_pooled_words` equals the reference's word scan
    (padding bits and 32 at n == 0 included), at the module's chunk size
    and with the chunk shrunk to 1 and 3 words, so the zero run crosses
    chunk boundaries; all-ones words are negative as int32."""
    if chunk is not None:
        monkeypatch.setattr(codecs, "GOLOMB_CHUNK_WORDS", chunk)
    bits, words = _pooled(n, p, 7 * n + int(100 * p))
    # an uneven pool: a second leaf's words after the first's padding
    words = np.concatenate([words, words[: len(words) // 2]])
    m = n + 32 * (len(words) // 2) if n else 0
    got = codecs.get_codec("golomb").measure_pooled_words(
        torch.from_numpy(words.view(np.int32).copy()), m)
    want = int(jcodecs.get_codec("golomb").measure_pooled_words(
        jnp.asarray(words), m))
    assert got == want
    if n:
        payload = (api.BitpackedMasks.from_masks(
            {"a": torch.from_numpy(bits), "b": torch.from_numpy(bits[:5])},
            None))
        assert codecs.get_codec("golomb").measure_bits(payload) == \
            codecs.get_codec("golomb").encode(payload).wire_bits


@pytest.mark.parametrize("name", ("bitpack", "golomb"))
def test_measure_pooled_words_empty_and_rows(name):
    codec = codecs.get_codec(name)
    assert codec.measure_pooled_words(torch.zeros(0, dtype=torch.int32),
                                      0) == \
        codec.measure_pooled_bits(torch.zeros(0, dtype=torch.uint8))
    # cohort rows, as the round step meters them
    n = 96
    bits = (np.random.default_rng(0).random((4, n)) < 0.2).astype(np.uint8)
    words = api.pack_leaf(torch.from_numpy(bits[0]))
    rows = torch.stack([api.pack_leaf(torch.from_numpy(b)) for b in bits])
    assert torch.equal(rows[0], words)
    assert [codec.measure_pooled_words(r, n) for r in rows] == [
        codec.measure_pooled_bits(torch.from_numpy(b)) for b in bits]


# ---------------------------------------------------------------------------
# Integrity
# ---------------------------------------------------------------------------


def _payload_of(name):
    if name == "float32":
        return _float_pair()[0]
    if name == "signpack":
        return _sign_pair()[0]
    return _mask_pair()[0]


@pytest.mark.parametrize("name", ALL)
def test_flipped_bit_raises_checksum_error(name):
    """A bit flipped in transit (in the words or the sidecar) fails
    `verify` and makes `decode` raise; the intact message verifies."""
    codec = codecs.get_codec(name)
    msg = codec.encode(_payload_of(name))
    assert msg.verify()
    stream = msg.words[0] if msg.words[0].size else msg.sidecar[0]
    stream[stream.size // 2] ^= np.uint32(1 << 7)
    assert not msg.verify()
    with pytest.raises(codecs.ChecksumError):
        codec.decode(msg)
    stream[stream.size // 2] ^= np.uint32(1 << 7)
    codec.decode(msg)


def test_words_checksum_reads_int32_words_as_uint32():
    """The CRC32 over int32-stored words (the card's layout, sign bit
    set) equals the reference's over the same uint32 words."""
    w = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 12345], np.uint32)
    from repro_torch.core import aggregation
    want = jaggregation.words_checksum([w, w[:2]])
    assert aggregation.words_checksum([w, w[:2]]) == want
    assert aggregation.words_checksum(
        [torch.from_numpy(w.view(np.int32).copy()), w[:2]]) == want
