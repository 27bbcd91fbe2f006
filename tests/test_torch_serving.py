"""The port's serving path against the JAX package: frozen decode trees
(`freeze_identity`), the freeze-cache's LRU, KV-cache `decode_step` on
internlm2 and deepseek-v2-lite SMOKE (GQA and MLA, dense and MoE
stacks), and the port's own serving properties: frozen decode against
the fused training forward on every ported family, decode through an
unfrozen masked tree against the frozen one, the refusals that remain,
tenant isolation through the engine, the engine's input checks,
eviction freeing memory, and the serve CLI.  (The ssm, hybrid and
gemma3 decode steps against the JAX package: tests/test_torch_{ssm,
hybrid}_decode.py and tests/test_torch_gemma3.py.)"""
import dataclasses
import functools
import gc
import re
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import masking as jmasking
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtransformer

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import masking, tree
from repro_torch.core.masking import MaskedParams
from repro_torch.launch import serve
from repro_torch.models import build_model, transformer
from repro_torch.runtime.serve_engine import ServeEngine
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

_NONE = lambda x: x is None
DECODE_ARCHS = ("internlm2-1.8b", "deepseek-v2-lite-16b", "mamba2-370m",
                "recurrentgemma-9b", "gemma3-4b")
KV_ARCHS = DECODE_ARCHS[:2]     # the KV-cache transformers of `_decode_both`


def _np(t):
    return jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x), t, is_leaf=_NONE)


@functools.lru_cache(maxsize=None)
def _jax_mp(arch, seed=3):
    japi = jbuild_model(jget_config(arch, smoke=True))
    jmp = jax.jit(lambda k: jmasking.init_masked(
        k, japi.init_params(k), jmasking.MaskSpec()))(
        jax.random.PRNGKey(seed))
    return japi, jmp


def _jax_freeze(jmp, ident):
    return jax.jit(lambda m: jmasking.freeze_identity(m, ident))(jmp)


def _port_mp(jmp) -> MaskedParams:
    return MaskedParams(*(convert.tree_to_torch(_np(t), "cpu")
                          for t in (jmp.weights, jmp.scores, jmp.floats)))


def _port(arch, seed=0):
    """A port-only SMOKE model and its MaskedParams on the CPU."""
    api = build_model(get_config(arch, smoke=True))
    gen = torch.Generator().manual_seed(seed)
    mp = masking.init_masked(gen, api.init_params(gen), masking.MaskSpec())
    return api, mp


@pytest.fixture(scope="module", params=KV_ARCHS)
def frozen_pair(request):
    """(arch, JAX api, JAX frozen tree, port frozen tree) in threshold
    mode, one state carried across."""
    japi, jmp = _jax_mp(request.param)
    jfz = _jax_freeze(jmp, jmasking.MaskIdentity(seed=11))
    tfz = masking.freeze_identity(_port_mp(jmp), masking.MaskIdentity(
        seed=11))
    return request.param, japi, jfz, tfz


@pytest.mark.parametrize("arch", DECODE_ARCHS)
@pytest.mark.parametrize("mode", ("threshold", "sample"))
def test_freeze_identity_matches_jax(arch, mode):
    """m * w of every masked leaf and the float leaves pass-through:
    equal to the reference's frozen tree, exactly (the same hash stream
    and thresholds; m * w is exact)."""
    _, jmp = _jax_mp(arch)
    ident = dict(seed=11, mode=mode, cohort=1)
    jfz = _jax_freeze(jmp, jmasking.MaskIdentity(**ident))
    tfz = masking.freeze_identity(_port_mp(jmp),
                                  masking.MaskIdentity(**ident))
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jfz)]
    tl = [x for x in tree.leaves(tfz) if x is not None]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert not b.requires_grad and b.grad_fn is None
        assert str(b.dtype).split(".")[1] == a.dtype.name
        assert np.array_equal(b.float().numpy(), a.astype(np.float32))


def test_freeze_cache_matches_jax_lru():
    """One access sequence through both caches: the same builds, hits,
    misses, evictions and LRU -> MRU key order after every access."""
    seq = [1, 2, 1, 3, 2, 4, 4, 1, 3, 3, 2]
    built = {"jax": [], "port": []}
    jc = jmasking.FreezeCache(lambda k: built["jax"].append(k) or k, 3)
    tc = masking.FreezeCache(lambda k: built["port"].append(k) or k, 3)
    for k in seq:
        assert jc.get(k) == tc.get(k) == k
        assert tc.keys() == jc.keys()
        assert len(tc) == len(jc) <= 3
        assert (k in tc) and (k in jc)
    assert tc.stats() == jc.stats()
    assert built["port"] == built["jax"]
    with pytest.raises(ValueError):
        masking.FreezeCache(lambda k: k, 0)


def test_byte_accounting_matches_jax():
    _, jmp = _jax_mp("internlm2-1.8b")
    tmp = _port_mp(jmp)
    assert masking.masked_delta_bytes(tmp) == \
        jmasking.masked_delta_bytes(jmp)
    assert masking.mask_artifact_bytes(tmp) == \
        jmasking.mask_artifact_bytes(jmp)
    assert masking.count_params(tmp.scores) == \
        jmasking.count_params(jmp.scores)
    assert [p for p, _ in masking.leaves_with_paths(tmp.scores)] == \
        [p for p, _ in jmasking.leaves_with_paths(jmp.scores)]


def _decode_both(japi, jtree, ttree, cache_dtype, eager, steps=8, B=2):
    """`steps` tokens through the reference's jitted decode (and, with
    `eager`, its eager decode) and the port's; returns (port-vs-jit,
    eager-vs-jit, logit scale)."""
    cfg = japi.cfg
    api = build_model(_port_cfg(cfg))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, steps))
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    jc = jtransformer.init_cache(cfg, B, steps, dtype=jdt[cache_dtype])
    je = jtransformer.init_cache(cfg, B, steps, dtype=jdt[cache_dtype])
    tc = transformer.init_cache(api.cfg, B, steps, "cpu", dtype=cache_dtype)
    dec = jax.jit(japi.decode_step)
    port, spread, scale = 0.0, 0.0, 0.0
    for t in range(steps):
        tok, pos = jnp.asarray(tokens[:, t], jnp.int32), jnp.asarray(
            t, jnp.int32)
        jl, jc = dec(jtree, jc, tok, pos)
        if eager:
            with jax.disable_jit():
                el, je = japi.decode_step(jtree, je, tok, pos)
            spread = max(spread, float(np.abs(np.asarray(el)
                                              - np.asarray(jl)).max()))
        tl, tc = api.decode_step(ttree, tc, torch.from_numpy(tokens[:, t]),
                                 t)
        jl = np.asarray(jl)
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        port = max(port, float(np.abs(tl.numpy() - jl).max()))
        scale = max(scale, float(np.abs(jl).max()))
    return port, spread, scale


def _port_cfg(jcfg):
    name = {"internlm2-smoke": "internlm2-1.8b",
            "dsv2-lite-smoke": "deepseek-v2-lite-16b"}[jcfg.name]
    return get_config(name, smoke=True)


def test_decode_step_f32_matches_jax(frozen_pair):
    """All-f32 params and cache: 8 decode steps equal the reference's to
    f32 rounding (sums in another order; measured 2.3e-6 of a 0.8 logit
    scale), so the tolerance is 2e-5 of the scale."""
    _, japi, jfz, _ = frozen_pair
    f32 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, jfz)
    port, _, scale = _decode_both(japi, f32, convert.tree_to_torch(
        _np(f32), "cpu"), torch.float32, eager=False)
    assert port <= 2e-5 * scale, (port, scale)


def test_decode_step_bf16_within_reference_spread(frozen_pair):
    """bf16 params and cache: each framework rounds its bf16 ops at its
    own points, and the reference's own jitted and eager decodes differ
    (measured 0.017 and 0.0057 of scales 0.81 and 0.76).  The port must
    sit within twice that spread of the jitted reference, and within 3%
    of the logit scale."""
    _, japi, jfz, tfz = frozen_pair
    port, spread, scale = _decode_both(japi, jfz, tfz, torch.bfloat16,
                                       eager=True)
    assert port <= max(2 * spread, 1e-3 * scale), (port, spread)
    assert port <= 0.03 * scale, (port, scale)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
@pytest.mark.parametrize("mode", ("sample", "threshold"))
def test_frozen_decode_matches_fused_forward(arch, mode):
    """Decoding a frozen tree token by token matches the fused masked
    training forward (the kernels' plain versions) on the same tokens,
    within the reference's bound for this property (0.02: bf16 KV cache
    and bf16 products in another order; a wrong mask moves logits by
    O(1); 0.15 for the hybrid, as the reference's).  The MoE stack runs
    at a capacity factor E/k, at which no expert drops a token in either
    pass: a forward over B*S tokens and a decode step over B tokens
    otherwise drop different ones.  Ten tokens pass the SMOKE window of
    8, so gemma3's and recurrentgemma's windows bind."""
    api, mp = _port(arch, seed=5)
    if api.cfg.n_experts:
        api = build_model(dataclasses.replace(
            api.cfg, capacity_factor=api.cfg.n_experts / api.cfg.top_k))
    B, S = 2, 10
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, api.cfg.vocab, (B, S)))
    seed_fn = lambda i: masking.mask_stream_seed(0, 0, i, 0, run_seed=9)
    fused = masking.masked_forward_tree(mp, seed_fn, mode=mode)
    with torch.no_grad():
        ref_logits = api.forward(fused, {"tokens": tokens})[0]
    frozen = masking.freeze_for_decode(fused)
    cache = api.init_cache(B, S, "cpu")
    errs = []
    for t in range(S):
        logits, cache = api.decode_step(frozen, cache, tokens[:, t], t)
        errs.append(float((logits - ref_logits[:, t]).abs().max()))
    tol = 0.15 if api.cfg.family == "hybrid" else 0.02
    assert max(errs) < tol, errs


@pytest.mark.parametrize("arch,tol", (("mamba2-370m", None),
                                      ("recurrentgemma-9b", 0.15),
                                      ("gemma3-4b", None)))
def test_unfrozen_masked_decode_matches_frozen(arch, tol):
    """Decoding straight through the unfrozen `MaskedLeaf` tree (the
    masked kernels' plain versions, and `conv1d_step` materializing its
    kernel every step) samples the same masks as `freeze_for_decode`:
    the reference's bounds, bit for bit for the ssm family and within
    0.15 for the hybrid (here on the CPU bit for bit as well)."""
    api, mp = _port(arch, seed=6)
    B, S = 1, 6
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, api.cfg.vocab, (B, S)))
    seed_fn = lambda i: masking.mask_stream_seed(0, 0, i, 0, run_seed=4)
    masked = masking.masked_forward_tree(mp, seed_fn, mode="sample")
    frozen = masking.freeze_for_decode(masked)
    c1, c2 = api.init_cache(B, S, "cpu"), api.init_cache(B, S, "cpu")
    for t in range(S):
        l1, c1 = api.decode_step(frozen, c1, tokens[:, t], t)
        l2, c2 = api.decode_step(masked, c2, tokens[:, t], t)
        if tol is None:
            assert torch.equal(l1, l2), f"{arch}: diverged at t={t}"
        else:
            assert float((l1 - l2).abs().max()) <= tol, t
    for a, b in zip(tree.leaves(c1), tree.leaves(c2)):
        assert tol is not None or torch.equal(a, b)


def test_decode_not_ported_families_raise():
    """The configs the port once refused decode now: a soft cap (which no
    model of the reference reads) decodes as the uncapped config does,
    and block MoE dispatch builds its cache and decodes (a decode step
    routes its batch globally, as the reference's).  qkv bias and the
    encdec and VLM families are ported: they build, and the layer-norm
    config decodes."""
    base = get_config("gemma3-4b", smoke=True)
    params = build_model(base).init_params(torch.Generator().manual_seed(0))
    tok = torch.zeros(1, dtype=torch.int64)
    logits = []
    for cfg in (base, dataclasses.replace(base, attn_soft_cap=50.0)):
        api = build_model(cfg)
        logits.append(api.decode_step(params, api.init_cache(1, 4, "cpu"),
                                      tok, 0)[0])
    assert torch.equal(logits[0], logits[1])
    moe = dataclasses.replace(get_config("deepseek-v2-lite-16b", smoke=True),
                              moe_block_dispatch=64)
    api = build_model(moe)
    out, _ = api.decode_step(api.init_params(torch.Generator().manual_seed(0)),
                             api.init_cache(1, 4, "cpu"), tok, 0)
    assert bool(torch.isfinite(out).all())
    build_model(dataclasses.replace(base, qkv_bias=True)).init_cache(
        1, 4, "cpu")
    for arch in ("whisper-medium", "qwen2-vl-2b"):
        api = build_model(get_config(arch, smoke=True))
        params = api.init_params(torch.Generator().manual_seed(0))
        logits, _ = api.decode_step(params, api.init_cache(1, 4, "cpu"),
                                    torch.zeros(1, dtype=torch.int64), 0)
        assert logits.shape == (1, 256) and bool(
            torch.isfinite(logits).all())


def _solo(api, mp, seed, prompt, gen, max_seq, mode):
    eng = ServeEngine(api, mp, slots=1, cache_capacity=1, max_seq=max_seq)
    eng.register_tenant("solo", seed=seed, mode=mode)
    rid = eng.submit("solo", prompt, gen)
    return eng.run()[rid]


def test_tenant_isolation_bit_identity():
    """3 tenants (distinct mask seeds, staggered prompt and generation
    lengths) interleaved on 2 slots: each tenant's logits and tokens are
    bit-identical to that tenant decoded alone."""
    api, mp = _port("internlm2-1.8b")
    prompts = np.random.default_rng(2).integers(0, api.cfg.vocab, (3, 10))
    lens = [(10, 6), (7, 8), (4, 5)]
    eng = ServeEngine(api, mp, slots=2, cache_capacity=3, max_seq=18)
    rids = []
    for i, (P, G) in enumerate(lens):
        eng.register_tenant(f"t{i}", seed=100 + i, mode="sample")
        rids.append(eng.submit(f"t{i}", prompts[i, :P], G))
    done = eng.run()
    assert eng.mixed_ticks > 0
    for i, (P, G) in enumerate(lens):
        got = done[rids[i]]
        solo = _solo(api, mp, 100 + i, prompts[i, :P], G, 18, "sample")
        assert got.tokens == solo.tokens and len(got.tokens) == G
        assert got.prefill_steps == P - 1 and got.decode_steps == G
        for a, b in zip(got.decode_logits, solo.decode_logits):
            assert torch.equal(a, b)
    st = eng.stats()
    assert st["decode_tokens"] == sum(G for _, G in lens)
    assert st["prefill_tokens"] == sum(P - 1 for P, _ in lens)
    assert st["misses"] == st["freezes"] == 3 and st["max_occupancy"] == 3


def test_engine_input_validation():
    api, mp = _port("internlm2-1.8b")
    with pytest.raises(ValueError):
        ServeEngine(api, mp, slots=0)
    with pytest.raises(ValueError):
        ServeEngine(api, mp, cache_capacity=0)
    eng = ServeEngine(api, mp, slots=1, max_seq=8)
    with pytest.raises(ValueError):
        eng.register_tenant("a")
    eng.register_tenant("a", seed=1)
    with pytest.raises(ValueError):
        eng.register_tenant("a", seed=2)
    scores = mp.scores
    eng.register_tenant("b", seed=3, scores=scores)
    with pytest.raises(ValueError):
        eng.register_tenant("c", masking.MaskIdentity(seed=3, tag="b"),
                            scores=tree.tree_map(
                                lambda s: None if s is None else s.clone(),
                                scores))
    with pytest.raises(KeyError):
        eng.submit("nobody", [1, 2], 2)
    with pytest.raises(ValueError):
        eng.submit("a", [], 2)
    with pytest.raises(ValueError):
        eng.submit("a", [1, 2, 3, 4, 5], 4)
    assert eng.submit("a", [1, 2, 3], 5) == 0
    assert eng.step() is True


def test_eviction_frees_the_tree():
    """With the cyclic collector off, the evicted frozen tree's tensors
    die as soon as the cache and the caller drop it."""
    api, mp = _port("internlm2-1.8b")
    cache = masking.FreezeCache(lambda ident: masking.freeze_identity(
        mp, ident), 1)
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        first = cache.get(masking.MaskIdentity(seed=1))
        leaf = next(x for x in tree.leaves(first["layers"])
                    if x is not None and x.ndim == 3)
        ref = weakref.ref(leaf)
        del first, leaf
        assert ref() is not None
        cache.get(masking.MaskIdentity(seed=2))
        assert cache.evictions == 1
        assert ref() is None
    finally:
        if was_enabled:
            gc.enable()


def test_serve_cli_prints_reference_lines(capsys):
    out = serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "5", "--tokens", "3"])
    line = capsys.readouterr().out
    # the default arch is the reference launcher's, gemma3-4b
    assert re.search(r"gemma3-smoke: 2 requests, prefill 8 tok in "
                     r"[\d.]+s \([\d.]+ tok/s\), decode 6 tok in [\d.]+s "
                     r"\([\d.]+ tok/s\)", line), line
    assert out["decode_tokens"] == 6 and out["prefill_tokens"] == 8
    assert out["tokens"].shape == (2, 3)
    assert torch.isfinite(out["last_logits"]).all()

    out = serve.main(["--smoke", "--device", "cpu", "--tenants", "3",
                      "--slots", "2", "--cache-capacity", "2",
                      "--prompt-len", "4", "--tokens", "3"])
    text = capsys.readouterr().out
    assert re.search(r"gemma3-smoke: 3/3 tenants served on 2 slots "
                     r"\(freeze-cache 2/2, 0 hits / 3 misses / 1 "
                     r"evictions\)", text), text
    assert re.search(r"prefill 9 tok \([\d.]+ tok/s\), decode 9 tok", text)
    assert re.search(r"resident HBM: 1 x w \(\d+ B\) \+ 2 x delta \(\d+ B\) "
                     r"= \d+ B for 3 tenants \(mask artifact \d+ B/tenant\)",
                     text), text
    assert out["served"] == 3 and out["max_occupancy"] == 2


def test_serve_cli_runs_on_the_card_by_default(monkeypatch):
    """Without --device the launcher asks for the card and raises where
    there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--smoke"])
