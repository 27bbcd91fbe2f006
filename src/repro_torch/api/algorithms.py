"""The six federated algorithms of `repro.api.algorithms`, in the
`FedAlgorithm` protocol with typed payloads in both directions.

  name         payload          codec       downlink            reference
  -----------  ---------------  ----------  ------------------  ---------
  fedpm_reg    BitpackedMasks   arithmetic  ProbBroadcast k=8   the paper
  fedpm        BitpackedMasks   arithmetic  ProbBroadcast k=8   FedPM
  fedmask      BitpackedMasks   arithmetic  FloatBroadcast      Li et al.
  topk         BitpackedMasks   arithmetic  FloatBroadcast      top-k [4]
  mv_signsgd   SignVotes        signpack    FloatBroadcast      [12]
  fedavg       FloatDeltas      float32     FloatBroadcast      [1]

Each is a factory `f(apply_fn, loss_fn, *, spec=None, **hp)` registered
under its name; resolve it with `api.get_algorithm`.  Every factory takes
`codec=` to swap the wire codec; the fedpm family takes `downlink_bits=`
for the k-bit theta broadcast (clients train from the dequantized copy).
The fedpm rows reuse `core.federated.make_client_update`, so the
host-sim engine and this API cannot diverge.

A client's draws come from the round's generator or are injected as its
`u`: the fedpm rows take `make_client_update`'s, topk one list of
uniforms over the masked leaves a local step (`sample_effective`'s), and
mv_signsgd one uniform tensor a float leaf for its zero-gradient coin
(+1 where u < 0.5, the reference's `rademacher`).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.api import payloads as plds
from repro_torch.api.protocol import FedAlgorithm, PayloadSpec
from repro_torch.api.registry import register
from repro_torch.core import federated, masking, regularizer
from repro_torch.core import tree as tu
from repro_torch.optim import optimizers as optlib

Pytree = Any


def _default_spec(spec):
    return masking.MaskSpec() if spec is None else spec


# ---------------------------------------------------------------------------
# FedPM family: the paper's method (lam > 0) and the FedPM reference
# ---------------------------------------------------------------------------


MASK_SPEC = PayloadSpec(
    plds.BitpackedMasks, nominal_bpp=None,
    description="bitpacked binary masks; entropy-coded <= 1 Bpp",
    default_codec="arithmetic")


def _prob_downlink(bits: int):
    """Server -> clients: theta over the k-bit quantized wire
    (`ProbBroadcast`); the clients train from the dequantized copy."""
    def downlink(state, generator, u=None):
        pay = plds.ProbBroadcast.from_theta(state.theta, generator,
                                            bits=bits, floats=state.floats,
                                            u=u)
        return pay, state._replace(theta=pay.to_theta())
    return downlink


def _float_downlink(select):
    """Server -> clients: the raw float broadcast (lossless, 32 Bpp)."""
    def downlink(state, generator, u=None):
        return plds.FloatBroadcast.from_tree(select(state)), state
    return downlink


def _fedpm_family(name, apply_fn, loss_fn, *, spec=None, cfg=None,
                  lam=1.0, local_steps=3, lr=0.1, float_lr=0.01,
                  optimizer="sgd", bayesian=False, train_floats=True,
                  codec=None, downlink_bits=8):
    spec = _default_spec(spec)
    if cfg is None:
        cfg = federated.FedConfig(
            lam=lam, local_steps=local_steps, lr=lr, float_lr=float_lr,
            optimizer=optimizer, bayesian=bayesian,
            train_floats=train_floats)
    local = federated.make_client_update(apply_fn, loss_fn, cfg)

    def init(gen, params_like):
        return federated.init_server(gen, params_like, spec)

    def client_update(state, data, generator, u=None):
        mask, floats, metrics = local(state.weights, state.floats,
                                      state.theta, data, generator, u)
        metrics.pop("uplink_bpp", None)   # the transport layer owns it
        return plds.BitpackedMasks.from_masks(mask, floats), metrics

    def pooled_aggregate(state, q, floats, k):
        # the server's transition given q = the weighted mask mean, the
        # pooled floats and the folded count k (an aggregator tree
        # reduces them from pooled counts)
        if cfg.bayesian:
            k = torch.as_tensor(k, dtype=torch.float32)
            theta = tu.tree_map(lambda t: None if t is None else
                                (1.0 + t * k) / (2.0 + k), q)
        else:
            theta = q
        return federated.ServerState(
            theta=theta, floats=floats, weights=state.weights,
            seed=state.seed, round=state.round + 1)

    def aggregate(state, payloads, wn, participation):
        return pooled_aggregate(
            state, plds.batched_packed_mean(payloads, wn),
            plds.batched_float_mean(payloads.floats, wn),
            participation.float().sum())

    def eval_params(state, generator, u=None):
        scores = masking.scores_from_theta(state.theta)
        mp = masking.MaskedParams(state.weights, scores, state.floats)
        return masking.sample_effective(mp, generator, mode="sample", u=u)

    return FedAlgorithm(name, init=init, client_update=client_update,
                        aggregate=aggregate, eval_params=eval_params,
                        payload_spec=MASK_SPEC, codec=codec,
                        downlink=_prob_downlink(downlink_bits),
                        pooled_aggregate=pooled_aggregate)


@register("fedpm_reg", payload_spec=MASK_SPEC,
          description="regularized FedPM (the paper; lam > 0)")
def fedpm_reg(apply_fn, loss_fn, *, spec=None, lam=1.0, **kw):
    return _fedpm_family("fedpm_reg", apply_fn, loss_fn, spec=spec,
                         lam=lam, **kw)


@register("fedpm", payload_spec=MASK_SPEC,
          description="FedPM reference (no regularizer)")
def fedpm(apply_fn, loss_fn, *, spec=None, **kw):
    kw.pop("lam", None)
    return _fedpm_family("fedpm", apply_fn, loss_fn, spec=spec, lam=0.0,
                         **kw)


# ---------------------------------------------------------------------------
# FedMask: deterministic STE-threshold masking
# ---------------------------------------------------------------------------


class MaskState(NamedTuple):
    scores: Pytree
    floats: Pytree
    weights: Pytree
    round: int


def _mask_init(spec):
    def init(gen, params_like):
        mp = masking.init_masked(gen, params_like, spec)
        return MaskState(mp.scores, mp.floats, mp.weights, 0)
    return init


def _mask_pooled_aggregate(state, q, floats, k):
    # the scores from the reduced mask mean; payload floats are ignored
    # on this family
    return MaskState(masking.scores_from_theta(q), state.floats,
                     state.weights, state.round + 1)


def _mask_aggregate(state, payloads, wn, participation):
    return _mask_pooled_aggregate(
        state, plds.batched_packed_mean(payloads, wn), None, None)


def _train_scores(apply_fn, loss_fn, opt, state, data, generator=None,
                  u=None, mode="sample", tau=0.5):
    """H local steps of `opt` on the scores (H the data's leading axis),
    the forward through `sample_effective` in `mode` with the STE; a
    sampled step t draws from `generator` or takes `u[t]`.  Returns (the
    scores, the last step's loss)."""
    sc, os = state.scores, opt.init(state.scores)
    for t in range(tu.leaves(data)[0].shape[0]):
        batch = tu.tree_map(lambda v: v[t], data)
        st = federated._trainable(sc)
        with torch.enable_grad():
            eff = masking.sample_effective(
                masking.MaskedParams(state.weights, st, state.floats),
                generator, mode=mode, tau=tau,
                u=None if u is None else u[t])
            loss = loss_fn(apply_fn(eff, batch), batch)
            (g,) = federated._grads(loss, (st,))
        with torch.no_grad():
            upd, os = opt.update(g, os, sc)
            sc = optlib.apply_updates(sc, upd)
    return sc, loss.detach()


_SCORE_DOWNLINK = _float_downlink(
    lambda s: {"scores": s.scores, "floats": s.floats})


@register("fedmask", payload_spec=MASK_SPEC,
          description="deterministic STE-threshold masks")
def fedmask(apply_fn, loss_fn, *, spec=None, tau=0.5, lr=0.1,
            local_steps=3, codec=None):
    """The forward uses m = 1[sigmoid(s) > tau] with the STE, momentum on
    the scores; the uplink is the thresholded mask (the biased-update
    baseline, paper footnote 3).  The local steps are the data's leading
    axis."""
    spec = _default_spec(spec)
    opt = optlib.momentum(lr)

    def client_update(state, data, generator, u=None):
        sc, loss = _train_scores(apply_fn, loss_fn, opt, state, data,
                                 mode="threshold", tau=tau)
        mask = tu.tree_map(lambda s: None if s is None else
                           (torch.sigmoid(s) > tau).to(torch.uint8), sc)
        metrics = {"loss": loss, "sparsity": regularizer.sparsity(mask)}
        return plds.BitpackedMasks.from_masks(mask), metrics

    def eval_params(state, generator, u=None):
        mp = masking.MaskedParams(state.weights, state.scores, state.floats)
        return masking.sample_effective(mp, mode="threshold", tau=tau)

    return FedAlgorithm("fedmask", init=_mask_init(spec),
                        client_update=client_update,
                        aggregate=_mask_aggregate, eval_params=eval_params,
                        payload_spec=MASK_SPEC, codec=codec,
                        downlink=_SCORE_DOWNLINK,
                        pooled_aggregate=_mask_pooled_aggregate)


# ---------------------------------------------------------------------------
# Top-k over scores: a deterministic sparse mask
# ---------------------------------------------------------------------------


def _quantile_f32(flat: torch.Tensor, q: float) -> torch.Tensor:
    """`jnp.quantile(flat, q)` (method "linear") in the reference's f32
    arithmetic: position q (n - 1), the two order statistics around it
    from a sort, weighted by the position's fraction, the high term fused
    into the add as XLA's CPU code fuses it (one FMA; the f32 products
    are exact in double).  (`torch.quantile` refuses more than 2^24
    elements and interpolates by `lerp`.)"""
    n = flat.numel()
    f32 = np.float32
    pos = f32(q) * (f32(n) - f32(1))
    lo, hi = np.floor(pos), np.ceil(pos)
    hw = pos - lo
    lw = f32(1) - hw
    lo_i, hi_i = (int(np.clip(v, 0, n - 1)) for v in (lo, hi))
    srt = torch.sort(flat).values
    low = f32(srt[lo_i].item()) * lw
    kth = f32(float(srt[hi_i].item()) * float(hw) + float(low))
    return torch.tensor(kth, dtype=torch.float32, device=flat.device)


@register("topk", payload_spec=MASK_SPEC,
          description="top-k% scores -> 1, rest pruned")
def topk(apply_fn, loss_fn, *, spec=None, k_frac=0.3, lr=0.1,
         local_steps=3, codec=None):
    """Train the scores as FedPM does (sampled masks, the STE, momentum),
    but the uplink mask sets the global top k_frac of the scores to 1 and
    prunes the rest.  The local steps are the data's leading axis."""
    spec = _default_spec(spec)
    opt = optlib.momentum(lr)

    def _topk_mask(scores):
        flat = torch.cat([s.reshape(-1) for s in tu.leaves(scores)
                          if s is not None])
        kth = _quantile_f32(flat, 1.0 - k_frac)
        return tu.tree_map(lambda s: None if s is None else
                           (s >= kth).to(torch.uint8), scores)

    def client_update(state, data, generator, u=None):
        sc, loss = _train_scores(apply_fn, loss_fn, opt, state, data,
                                 generator, u)
        mask = _topk_mask(sc)
        metrics = {"loss": loss, "sparsity": regularizer.sparsity(mask)}
        return plds.BitpackedMasks.from_masks(mask), metrics

    def eval_params(state, generator, u=None):
        mp = masking.MaskedParams(state.weights, state.scores, state.floats)
        return masking.sample_effective(mp, mode="threshold")

    return FedAlgorithm("topk", init=_mask_init(spec),
                        client_update=client_update,
                        aggregate=_mask_aggregate, eval_params=eval_params,
                        payload_spec=MASK_SPEC, codec=codec,
                        downlink=_SCORE_DOWNLINK,
                        pooled_aggregate=_mask_pooled_aggregate)


# ---------------------------------------------------------------------------
# MV-SignSGD: majority-vote sign compression (1 Bpp, float model)
# ---------------------------------------------------------------------------


SIGN_SPEC = PayloadSpec(plds.SignVotes, nominal_bpp=1.0,
                        description="bitpacked gradient signs, 1 Bpp",
                        default_codec="signpack")


class FloatState(NamedTuple):
    params: Pytree
    round: int


def _float_init(gen, params_like):
    return FloatState(params_like, 0)


def _float_grads(apply_fn, loss_fn, params, batch):
    """(loss, d loss / d params) at `params`, in each leaf's dtype."""
    pp = federated._trainable(params)
    with torch.enable_grad():
        loss = loss_fn(apply_fn(pp, batch), batch)
        (g,) = federated._grads(loss, (pp,))
    return loss.detach(), g


@register("mv_signsgd", payload_spec=SIGN_SPEC,
          description="majority-vote sign compression")
def mv_signsgd(apply_fn, loss_fn, *, spec=None, lr=1e-3, local_steps=3,
               codec=None):
    """Each client sums its gradients at the server's params over the
    local batches (in f32) and sends their signs; the server steps by lr
    against the weighted majority."""
    def client_update(state, data, generator, u=None):
        g_acc = tu.tree_map(lambda p: None if p is None else
                            torch.zeros_like(p, dtype=torch.float32),
                            state.params)
        H = tu.leaves(data)[0].shape[0]
        for t in range(H):
            loss, g = _float_grads(apply_fn, loss_fn, state.params,
                                   tu.tree_map(lambda v: v[t], data))
            g_acc = tu.tree_map(lambda a, b: None if a is None else
                                a + b.float(), g_acc, g)
        # the 1-bit wire has no zero: break exact-zero gradients (dead
        # units, zero biases) with a fair coin, so the majority vote has
        # no drift instead of a systematic -1
        it = iter(u) if u is not None else None

        def sign(gl):
            if gl is None:
                return None
            uu = next(it).to(gl.device) if it is not None else torch.rand(
                gl.shape, generator=generator, device=gl.device)
            coin = torch.where(uu < 0.5, 1.0, -1.0)
            return torch.where(gl == 0.0, coin, torch.sign(gl))

        signs = tu.tree_map(sign, g_acc)
        metrics = {"loss": loss, "sparsity": torch.tensor(0.0)}
        return plds.SignVotes.from_signs(signs), metrics

    def pooled_aggregate(state, q, floats, k):
        # majority vote: more than half the weighted sign bits +1 -> +1
        params = tu.tree_map(lambda p, qi: None if p is None else (
            p.float() - lr * torch.sign(2.0 * qi - 1.0)).to(p.dtype),
            state.params, q)
        return FloatState(params, state.round + 1)

    def aggregate(state, payloads, wn, participation):
        return pooled_aggregate(
            state, plds.batched_packed_mean(payloads, wn), None, None)

    return FedAlgorithm("mv_signsgd", init=_float_init,
                        client_update=client_update, aggregate=aggregate,
                        eval_params=lambda s, g=None, u=None: s.params,
                        payload_spec=SIGN_SPEC, codec=codec,
                        downlink=_float_downlink(lambda s: s.params),
                        pooled_aggregate=pooled_aggregate)


# ---------------------------------------------------------------------------
# FedAvg: the float reference (32-Bpp uplink)
# ---------------------------------------------------------------------------


FLOAT_SPEC = PayloadSpec(plds.FloatDeltas, nominal_bpp=32.0,
                         description="raw float32 deltas, 32 Bpp",
                         default_codec="float32")


@register("fedavg", payload_spec=FLOAT_SPEC,
          description="float weight averaging (32-Bpp reference)")
def fedavg(apply_fn, loss_fn, *, spec=None, lr=0.05, local_steps=3,
           codec=None):
    """Momentum steps on the params (in their dtypes) over the local
    batches; the uplink is the f32 delta, the server adds the weighted
    mean delta in f32 and casts back."""
    opt = optlib.momentum(lr)

    def client_update(state, data, generator, u=None):
        p, os = state.params, opt.init(state.params)
        H = tu.leaves(data)[0].shape[0]
        for t in range(H):
            loss, g = _float_grads(apply_fn, loss_fn, p,
                                   tu.tree_map(lambda v: v[t], data))
            with torch.no_grad():
                upd, os = opt.update(g, os, p)
                p = optlib.apply_updates(p, upd)
        delta = tu.tree_map(lambda a, b: None if a is None else
                            a.float() - b.float(), p, state.params)
        metrics = {"loss": loss, "sparsity": torch.tensor(0.0)}
        return plds.FloatDeltas.from_tree(delta), metrics

    def aggregate(state, payloads, wn, participation):
        mean_delta = plds.batched_float_mean(payloads.values, wn)
        params = tu.tree_map(lambda p, d: None if p is None else
                             (p.float() + d).to(p.dtype),
                             state.params, mean_delta)
        return FloatState(params, state.round + 1)

    return FedAlgorithm("fedavg", init=_float_init,
                        client_update=client_update, aggregate=aggregate,
                        eval_params=lambda s, g=None, u=None: s.params,
                        payload_spec=FLOAT_SPEC, codec=codec,
                        downlink=_float_downlink(lambda s: s.params))
