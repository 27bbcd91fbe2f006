"""The lockstep serving step of the port (`launch.steps.
make_multi_serve_step`, the engine's `lockstep=True`, the launcher's
`--lockstep`): one `torch.func.vmap`ped decode over slots, each with its
own frozen tree, cache, token and position, against the exact per-slot
mode on the traffic of the reference's `test_lockstep_mode_matches_exact
_mode` (3 tenants, 6-token prompts, 5 generated, on 2 slots), for every
ported family, gemma3's ring caches included.  The reference's bound:
tokens equal, logits within atol = rtol = 1e-5 (numerically equivalent,
not bit-exact; on the CPU the bf16 families agree bit for bit).  The
hybrid's gate projections are f32 products (f32 activations), which the
batched step sums in another order (about 1e-7 relative); a bf16 cast
downstream can then round one hidden element the other way (one bf16
ulp, 2**-8), which moved its logits by up to 3.7e-4 (logit scale 0.6)
on this traffic: its logits are held to 2e-3, tokens still equal."""
import dataclasses
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import masking, tree
from repro_torch.launch import serve, steps
from repro_torch.models import build_model
from repro_torch.runtime.serve_engine import ServeEngine
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ARCHS = ("internlm2-1.8b", "deepseek-v2-lite-16b", "mamba2-370m",
         "recurrentgemma-9b", "gemma3-4b", "gemma3-4b ring")


def _api(arch):
    if arch.endswith(" ring"):
        return build_model(dataclasses.replace(
            get_config(arch.split()[0], smoke=True), window_kv_cache=True))
    return build_model(get_config(arch, smoke=True))


def _mp(api, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return masking.init_masked(gen, api.init_params(gen), masking.MaskSpec())


def _run(api, mp, prompts, lens, lockstep, max_seq):
    eng = ServeEngine(api, mp, slots=2, cache_capacity=3, max_seq=max_seq,
                      lockstep=lockstep)
    rids = []
    for i, (P, G) in enumerate(lens):
        eng.register_tenant(f"t{i}", seed=50 + i)
        rids.append(eng.submit(f"t{i}", prompts[i, :P], G))
    done = eng.run()
    return [done[r] for r in rids], eng


def _agree(api, exact, lock, lens):
    tol = 2e-3 if api.cfg.family == "hybrid" else 1e-5
    for e, l, (P, G) in zip(exact, lock, lens):
        assert e.tokens == l.tokens and len(l.tokens) == G
        assert l.prefill_steps == P - 1 and l.decode_steps == G
        for a, b in zip(e.decode_logits, l.decode_logits):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol,
                                       rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_mode_matches_exact_mode(arch):
    api = _api(arch)
    mp = _mp(api)
    prompts = np.random.default_rng(3).integers(0, api.cfg.vocab, (3, 6))
    lens = [(6, 5)] * 3
    exact, _ = _run(api, mp, prompts, lens, False, 12)
    lock, eng = _run(api, mp, prompts, lens, True, 12)
    _agree(api, exact, lock, lens)
    st = eng.stats()
    assert st["decode_tokens"] == 15 and st["prefill_tokens"] == 15


@pytest.mark.parametrize("arch", ("internlm2-1.8b", "gemma3-4b ring",
                                  "recurrentgemma-9b"))
def test_lockstep_staggered_traffic_matches_exact_mode(arch):
    """The isolation traffic (prompt and generation lengths staggered, so
    one tick holds slots in prefill and in decode at other positions;
    the rings of 8 wrap): lockstep against exact, the same bound."""
    api = _api(arch)
    mp = _mp(api, seed=2)
    prompts = np.random.default_rng(2).integers(0, api.cfg.vocab, (3, 10))
    lens = [(10, 6), (7, 8), (4, 5)]
    exact, _ = _run(api, mp, prompts, lens, False, 18)
    lock, eng = _run(api, mp, prompts, lens, True, 18)
    assert eng.mixed_ticks > 0
    _agree(api, exact, lock, lens)


@pytest.mark.parametrize("arch", ("gemma3-4b ring", "recurrentgemma-9b"))
def test_multi_serve_step_equals_per_slot_steps(arch):
    """Three slots with their own trees at positions 0, 3 and 9 (past a
    ring of 8): one vmapped step against three `decode_step` calls, the
    logits and every cache written (atol = rtol = 1e-5; the hybrid's
    2e-3, as above)."""
    api = _api(arch)
    mp = _mp(api, seed=4)
    trees = [masking.freeze_identity(mp, masking.MaskIdentity(seed=s))
             for s in (1, 2, 3)]
    S, poss = 12, (0, 3, 9)
    toks = torch.randint(0, api.cfg.vocab, (3, S),
                         generator=torch.Generator().manual_seed(0))
    caches = [api.init_cache(1, S, "cpu") for _ in trees]
    for i, p in enumerate(poss):          # each slot's history
        for t in range(p):
            api.decode_step(trees[i], caches[i], toks[i, t:t + 1], t)
    stack = lambda *xs: torch.stack(xs)
    params = tree.tree_map(stack, *trees)
    stacked = tree.tree_map(stack, *caches)
    logits, stacked = steps.make_multi_serve_step(api)(
        params, stacked, torch.stack([toks[i, p:p + 1]
                                      for i, p in enumerate(poss)]),
        torch.tensor(poss))
    assert logits.shape == (3, 1, api.cfg.vocab)
    tol = 2e-3 if api.cfg.family == "hybrid" else 1e-5
    for i, p in enumerate(poss):
        want, _ = api.decode_step(trees[i], caches[i], toks[i, p:p + 1], p)
        np.testing.assert_allclose(logits[i].numpy(), want.numpy(),
                                   atol=tol, rtol=tol)
        for a, b in zip(tree.leaves(stacked), tree.leaves(caches[i])):
            np.testing.assert_allclose(a[i].float().numpy(),
                                       b.float().numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ("mamba2-370m", "recurrentgemma-9b",
                                  "gemma3-4b"))
def test_serve_cli_lockstep(arch, capsys):
    """`launch.serve --lockstep` on the multi-tenant engine: every tenant
    served, the reference's report lines."""
    out = serve.main(["--smoke", "--device", "cpu", "--arch", arch,
                      "--lockstep", "--tenants", "3", "--slots", "2",
                      "--prompt-len", "4", "--tokens", "3"])
    text = capsys.readouterr().out
    name = get_config(arch, smoke=True).name
    assert re.search(rf"{name}: 3/3 tenants served on 2 slots "
                     r"\(freeze-cache 2/2, 0 hits / 3 misses / 1 "
                     r"evictions\)", text), text
    assert re.search(r"prefill 9 tok \([\d.]+ tok/s\), decode 9 tok", text)
    assert out["served"] == 3 and out["lockstep"]
    assert all(bool(torch.isfinite(l).all()) for c in
               out["completions"].values() for l in c.decode_logits)


@pytest.mark.parametrize("lockstep", (False, True))
def test_engine_is_freed_without_the_collector(lockstep):
    """With the cyclic collector off, an engine, its frozen trees and its
    stacks die as soon as the caller drops it: no reference cycle (the
    freeze-cache's build function holds no reference to the engine), so
    one full-size serve run's memory is back before the next one's."""
    import gc
    import weakref
    api = _api("gemma3-4b")
    mp = _mp(api)
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        eng = ServeEngine(api, mp, slots=2, cache_capacity=2, max_seq=8,
                          lockstep=lockstep)
        for i in range(3):
            eng.register_tenant(f"t{i}", seed=i)
            eng.submit(f"t{i}", [1, 2, 3], 2)
        eng.run()
        leaf = eng.cache.get(masking.MaskIdentity(seed=0))["layers"][
            "mlp"]["w_up"]
        refs = [weakref.ref(eng), weakref.ref(leaf)]
        if lockstep:
            refs.append(weakref.ref(tree.leaves(eng._stacked_tree)[0]))
        del eng, leaf
        assert all(r() is None for r in refs)
    finally:
        if was_enabled:
            gc.enable()
