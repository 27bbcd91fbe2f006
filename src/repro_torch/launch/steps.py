"""The federated train and round steps (single device: the reference's
`repro.launch.steps` with `mesh=None`).

State layout as in the reference: `scores`, `floats`, `opt_m` (and
`opt_v` for adam) carry a leading cohort axis C; the frozen `weights`
have none; `step` counts train steps and rounds, and is the tick every
mask stream is keyed by.

* `make_train_step` — one local mini-batch score update per cohort on
  the fused path: the forward consumes a `masked_forward_tree`, every
  masked projection runs the masked-matmul kernels, and scores get the
  straight-through gradient plus lam times the eq. 12 entropy proxy's.
* `make_round_step` — the paper's communication event: each cohort's
  scores become packed mask words through the fused `sample_and_pack`
  kernel, theta is the (survivor-weighted) mean of the words, crosses
  the optional k-bit downlink, and resets every cohort's scores; the
  codec meters each cohort's pooled words.
* `make_fedavg_step` — the float reference (`--algo fedavg`): one plain
  autograd step of the float params with f32 momentum, no masks and no
  kernel of the port.
* `make_multi_serve_step` — the lockstep serving step: one vmapped
  decode over B slots, each with its own frozen tree, cache, token and
  position.

The reference vmaps over cohorts and returns new state; here the cohorts
run in a loop and the steps update the state's tensors in place (scores,
optimizer moments, floats), so a full-size model holds one copy of its
score state.  `step` is a Python int.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.api import codecs as codecs_lib
from repro_torch.api import payloads as plds
from repro_torch.core import aggregation, masking, regularizer
from repro_torch.core import tree as tu
from repro_torch.core.masking import MaskedLeaf, MaskedParams
from repro_torch.kernels import ref as kref

Pytree = Any


@dataclasses.dataclass(frozen=True)
class StepConfig:
    lam: float = 1.0
    lr: float = 0.1
    float_lr: float = 0.01
    momentum: float = 0.9
    optimizer: str = "momentum"      # "momentum" | "adam" (scores)
    adam_eps: float = 1e-8
    downlink_bits: int = 0           # k-bit theta broadcast (0 = f32)
    seed: int = 17                   # run seed mixed into every mask stream
    mask_mode: str = "sample"        # "sample" (fedpm*) | "threshold" (FedMask)
    tau: float = 0.5


# sentinel leaf index of the downlink quantizer's stream seed, far above
# any real leaf index
DOWNLINK_STREAM_LEAF = 1 << 20


def init_fed_state(gen: torch.Generator, api, spec: masking.MaskSpec, C: int,
                   optimizer: str = "momentum"):
    """Fed state on `gen`'s device; every cohort starts from the same
    scores and floats."""
    mp = masking.init_masked(gen, api.init_params(gen), spec)

    def rep(t):
        return None if t is None else t[None].repeat(
            (C,) + (1,) * t.ndim)

    scores = tu.tree_map(rep, mp.scores)
    zeros = lambda tree: tu.tree_map(
        lambda x: None if x is None else torch.zeros_like(x), tree)
    state = {"scores": scores, "floats": tu.tree_map(rep, mp.floats),
             "weights": mp.weights, "opt_m": zeros(scores), "step": 0}
    if optimizer == "adam":
        state["opt_v"] = zeros(scores)
    return state


def _blocks(t: torch.Tensor) -> list:
    """The per-layer blocks of a leaf: views along its leading (layer)
    axis, or the leaf itself when it is one (K, N) matrix.  A layer's
    block of a stacked expert leaf is its whole (E, K, N) slice, the
    operand of one grouped launch."""
    return [t] if t.ndim == 2 else list(t.unbind(0))


def _as_grad_leaves(leaf: MaskedLeaf) -> MaskedLeaf:
    """The leaf with each per-layer score block an autograd leaf of its
    own (views of the state's storage), so each block's gradient lands
    in its own `.grad` and no stacked gradient buffer is built."""
    blocks = [b.detach().requires_grad_() for b in _blocks(leaf.s)]
    return dataclasses.replace(
        leaf, s=blocks[0] if leaf.s.ndim == 2 else blocks)


def _score_blocks(leaf: MaskedLeaf) -> list:
    return [leaf.s] if isinstance(leaf.s, torch.Tensor) else list(leaf.s)


# elements a piece of the in-place score update (and of the round's
# downlink and score reset) works on: their f32 temporaries (the
# sigmoid, the regularizer's and the optimizer's products, the
# quantizer's) stay a piece's size, 256 MiB each, however large the
# block (a deepseek-v2-236b expert leaf holds 1.26 G scores)
UPDATE_PIECE = 1 << 26


def _pieces(g, s, m, v):
    """Matching flat pieces of UPDATE_PIECE elements of a score block,
    its gradient and its moments (v None under momentum), views of their
    storage.  Every op of the update is elementwise and a piece starts on
    a multiple of 2**26 elements (the vector loops' lanes line up), so
    updating piece by piece gives the same bits as the whole block."""
    flat = [None if t is None else t.detach().view(-1) for t in (g, s, m, v)]
    for i in range(0, flat[0].numel(), UPDATE_PIECE):
        yield [None if t is None else t[i:i + UPDATE_PIECE] for t in flat]


def make_train_step(api, cfg: StepConfig):
    """(state, batch) -> (state, {"loss"}); batch["tokens"]: (C, B, S)."""
    b1, b2 = 0.9, 0.999

    def cohort_update(state, c, batch_c):
        step = state["step"]
        scores_c = tu.tree_map(lambda s: None if s is None else s[c],
                               state["scores"])
        floats_c = tu.tree_map(
            lambda f: None if f is None else
            f[c].detach().requires_grad_(), state["floats"])
        mp = MaskedParams(state["weights"], scores_c, floats_c)
        params = masking.masked_forward_tree(
            mp, lambda i: masking.mask_stream_seed(step, 0, i, c,
                                                   run_seed=cfg.seed),
            mode=cfg.mask_mode, tau=cfg.tau)
        params = tu.tree_map(
            lambda p: _as_grad_leaves(p) if isinstance(p, MaskedLeaf)
            else p, params)
        loss = api.loss(api.forward(params, batch_c), batch_c)
        loss.backward()

        with torch.no_grad():
            leaves = [p for p in tu.leaves(params) if isinstance(p, MaskedLeaf)]
            n = sum(p.w.numel() for p in leaves)
            # d(lam * (1/n) sum sigmoid(s)) / ds = (lam / n) sigmoid'(s)
            dev = leaves[0].w.device
            coef = (torch.tensor(cfg.lam, dtype=torch.float32) /
                    torch.tensor(float(n), dtype=torch.float32)).to(dev)
            moms = [m[c] for m in tu.leaves(state["opt_m"]) if m is not None]
            vels = ([v[c] for v in tu.leaves(state["opt_v"]) if v is not None]
                    if "opt_v" in state else [None] * len(moms))
            if "opt_v" in state:
                t = torch.tensor(float(step + 1), dtype=torch.float32)
                bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** t).to(dev)
                bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** t).to(dev)
            for leaf, m_leaf, v_leaf in zip(leaves, moms, vels):
                m_blocks = _blocks(m_leaf)
                v_blocks = ([None] * len(m_blocks) if v_leaf is None
                            else _blocks(v_leaf))
                for s, m, v in zip(_score_blocks(leaf), m_blocks, v_blocks):
                    g = s.grad
                    if g is None:
                        g = torch.zeros_like(s)
                    for gp, sp, mp_, vp in _pieces(g, s, m, v):
                        if cfg.lam:
                            regularizer.entropy_proxy_grad_(gp, sp, coef)
                        if vp is None:
                            mp_.mul_(cfg.momentum).add_(gp)
                            sp.sub_(cfg.lr * mp_)
                        else:
                            mp_.mul_(b1).add_((1 - b1) * gp)
                            vp.mul_(b2).add_((1 - b2) * (gp * gp))
                            sp.sub_(cfg.lr * (mp_ / bc1)
                                    / (torch.sqrt(vp / bc2)
                                       + cfg.adam_eps))
                    s.grad = None
            for f in tu.leaves(floats_c):
                if f is not None and f.grad is not None:
                    f.sub_(cfg.float_lr * f.grad)
                    f.grad = None
        return loss.detach().float()

    def train_step(state, batch):
        C = next(s for s in tu.leaves(state["scores"]) if s is not None
                 ).shape[0]
        losses = [cohort_update(state, c, {k: v[c] for k, v in batch.items()})
                  for c in range(C)]
        state["step"] += 1
        return state, {"loss": torch.stack(losses).mean()}

    return train_step


def make_round_step(api, cfg: StepConfig, codec=None):
    """(state, participation=None, downlink_u=None) -> (state, metrics).

    `participation` (C floats, 1 = the cohort's uplink arrived) makes
    theta the survivor-renormalized mean and meters survivors only.
    The k-bit downlink draws its uniforms from a torch.Generator seeded
    with `mask_stream_seed(step, 0, DOWNLINK_STREAM_LEAF, 0, run_seed)`
    (the reference keys threefry with the same value, which torch cannot
    reproduce); `downlink_u` injects them instead (one tensor per masked
    leaf, flatten order).  Metrics: bpp (eq. 13 bound), bpp_measured,
    bits_measured, downlink_bpp, downlink_bits — float32 tensors."""
    codec = codecs_lib.get_codec(codec or "arithmetic")
    f32 = torch.float32

    def round_step(state, participation=None, downlink_u=None):
        step = state["step"]
        flat_s = tu.leaves(state["scores"])
        C = next(s for s in flat_s if s is not None).shape[0]
        dev = next(s for s in flat_s if s is not None).device
        part = wn = None
        if participation is not None:
            part = torch.as_tensor(participation, device=dev).to(f32)
            wn = part / torch.clamp(part.sum(), min=1.0)
        gen = None
        if cfg.downlink_bits and downlink_u is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(masking.mask_stream_seed(
                step, 0, DOWNLINK_STREAM_LEAF, 0, run_seed=cfg.seed))
        u_it = iter(downlink_u) if downlink_u is not None else None
        ones_c, word_parts, n_pool = None, [], 0
        for i, sl in enumerate(flat_s):
            if sl is None:
                continue
            flat = sl.reshape(C, -1)
            n = flat.shape[1]
            seeds = [masking.mask_stream_seed(step, 0, i, c,
                                              run_seed=cfg.seed)
                     for c in range(C)]
            words = aggregation.sample_and_pack_rows(
                flat, seeds, mode=cfg.mask_mode, tau=cfg.tau)
            ones = kref.popcount32(words).sum(dim=1).to(f32)
            ones_c = ones if ones_c is None else ones_c + ones
            word_parts.append(words)
            theta = plds.mean_from_words(words, n, weights=wn)
            u = None
            if cfg.downlink_bits:
                # the leaf's uniforms in one draw (quantize_theta's own)
                u = (next(u_it).reshape(-1) if u_it is not None else
                     torch.rand(theta.shape, generator=gen, device=dev))
            # theta crosses the downlink and every cohort restarts from
            # logit(theta), piece by piece (elementwise: the same bits,
            # with temporaries of a piece's size)
            for i in range(0, n, UPDATE_PIECE):
                t = theta[i:i + UPDATE_PIECE]
                if u is not None:
                    q = aggregation.quantize_theta(
                        [t], bits=cfg.downlink_bits,
                        u=[u[i:i + UPDATE_PIECE]])
                    t = aggregation.dequantize_theta(
                        q, bits=cfg.downlink_bits)[0]
                flat[:, i:i + UPDATE_PIECE].copy_(masking.logit(t)[None])
            del theta, u
            n_pool += n

        for f in tu.leaves(state["floats"]):
            if f is None:
                continue
            ff = f.float()
            avg = ff.mean(dim=0) if wn is None else torch.tensordot(
                wn, ff, dims=([0], [0]))
            f.copy_(avg.to(f.dtype)[None])
        for key in ("opt_m", "opt_v"):
            for m in tu.leaves(state.get(key)):
                if m is not None:
                    m.zero_()

        # eq. 13 meter from the popcounts (the packed words are never
        # unpacked for it); survivors only under participation
        if n_pool:
            if part is None:
                p1 = ones_c.sum() / torch.tensor(float(n_pool * C), dtype=f32,
                                                 device=dev)
            else:
                p1 = (ones_c * part).sum() / (
                    torch.tensor(float(n_pool), dtype=f32, device=dev)
                    * torch.clamp(part.sum(), min=1.0))
            bpp = regularizer.binary_entropy(p1)
        else:
            bpp = torch.zeros((), dtype=f32, device=dev)
        pooled = torch.cat(word_parts, dim=1) if word_parts else None
        per_cohort = torch.tensor(
            [codec.measure_pooled_words(pooled[c], n_pool) if n_pool else 0
             for c in range(C)], dtype=torch.int64).to(f32).to(dev)
        if part is not None:
            per_cohort = per_cohort * part
        bits_total = per_cohort.sum()
        eff = (torch.tensor(float(C), dtype=f32, device=dev) if part is None
               else torch.clamp(part.sum(), min=1.0))
        dl_bpp = float(cfg.downlink_bits) if cfg.downlink_bits else 32.0
        metrics = {
            "bpp": bpp,
            "bpp_measured": bits_total / (torch.tensor(
                float(n_pool), dtype=f32, device=dev) * eff),
            "bits_measured": bits_total,
            "downlink_bpp": torch.tensor(dl_bpp, dtype=f32),
            "downlink_bits": torch.tensor(dl_bpp * n_pool, dtype=f32,
                                          device=dev) * eff,
        }
        state["step"] += 1
        return state, metrics

    return round_step


# ---------------------------------------------------------------------------
# fedavg: the float reference
# ---------------------------------------------------------------------------


def init_fedavg_state(gen: torch.Generator, api):
    """{"params": random float params on `gen`'s device, "opt_m": f32
    zeros of their shapes, "step": 0}."""
    params = api.init_params(gen)
    return {"params": params,
            "opt_m": tu.tree_map(
                lambda x: None if x is None else torch.zeros_like(
                    x, dtype=torch.float32), params),
            "step": 0}


def make_fedavg_step(api, cfg: StepConfig):
    """(state, batch) -> (state, {"loss"}); batch["tokens"]: (B, S).  One
    autograd step on the float params: m = momentum * m + g in f32, then
    p = p - lr * m in p's dtype, both in place."""

    def fedavg_step(state, batch):
        params = tu.tree_map(
            lambda p: None if p is None else p.detach().requires_grad_(),
            state["params"])
        loss = api.loss(api.forward(params, batch), batch)
        loss.backward()
        with torch.no_grad():
            for p, m, dst in zip(tu.leaves(params),
                                 tu.leaves(state["opt_m"]),
                                 tu.leaves(state["params"])):
                if p is None:
                    continue
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                m.mul_(cfg.momentum).add_(g)
                dst.copy_((dst.float() - cfg.lr * m).to(dst.dtype))
                p.grad = None
        state["step"] += 1
        return state, {"loss": loss.detach().float()}

    return fedavg_step


# ---------------------------------------------------------------------------
# Lockstep serving: one vmapped decode over slots
# ---------------------------------------------------------------------------


def make_multi_serve_step(api):
    """Slot-major multi-tenant decode, the lockstep mode of
    `runtime.serve_engine.ServeEngine`: `torch.func.vmap` of
    `api.decode_step` over B slots, each carrying its own frozen params
    tree, cache, token and position, in one call for all of them.

    (params, caches, tokens, poss) -> (logits (B, 1, V), caches): params
    and caches are trees of (B, ...) stacks, tokens (B, 1) (an inner
    batch of 1 a slot), poss (B,) int, so slots at different positions
    (prefill and decode) advance together.  Each slot's cache is written
    in place, as `decode_step` writes it.  Numerically equivalent to B
    separate `decode_step` calls, not bit-exact (batched products sum in
    another order); the engine's exact per-slot mode is the bit-identity
    contract."""
    vstep = torch.func.vmap(
        lambda params, cache, token, pos: api.decode_step(
            params, cache, token, pos)[0])

    def multi_serve_step(params, caches, tokens, poss):
        return vstep(params, caches, tokens, poss), caches

    return multi_serve_step
