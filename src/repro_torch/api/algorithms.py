"""The mask-training federated algorithms of `repro.api.algorithms`, in
the `FedAlgorithm` protocol with typed payloads in both directions.

  name         payload          codec       downlink            reference
  -----------  ---------------  ----------  ------------------  ---------
  fedpm_reg    BitpackedMasks   arithmetic  ProbBroadcast k=8   the paper
  fedpm        BitpackedMasks   arithmetic  ProbBroadcast k=8   FedPM
  fedmask      BitpackedMasks   arithmetic  FloatBroadcast      Li et al.

Each is a factory `f(apply_fn, loss_fn, *, spec=None, **hp)` registered
under its name; resolve it with `api.get_algorithm`.  Every factory takes
`codec=` to swap the wire codec; the fedpm family takes `downlink_bits=`
for the k-bit theta broadcast (clients train from the dequantized copy).
The fedpm rows reuse `core.federated.make_client_update`, so the
host-sim engine and this API cannot diverge.  (topk, mv_signsgd and
fedavg are not ported yet.)
"""
from __future__ import annotations

from typing import Any, NamedTuple

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

    def aggregate(state, payloads, wn, participation):
        q = plds.batched_packed_mean(payloads, wn)
        if cfg.bayesian:
            k = participation.float().sum()
            theta = tu.tree_map(lambda t: None if t is None else
                                (1.0 + t * k) / (2.0 + k), q)
        else:
            theta = q
        floats = plds.batched_float_mean(payloads.floats, wn)
        return federated.ServerState(
            theta=theta, floats=floats, weights=state.weights,
            seed=state.seed, round=state.round + 1)

    def eval_params(state, generator, u=None):
        scores = masking.scores_from_theta(state.theta)
        mp = masking.MaskedParams(state.weights, scores, state.floats)
        return masking.sample_effective(mp, generator, mode="sample", u=u)

    return FedAlgorithm(name, init=init, client_update=client_update,
                        aggregate=aggregate, eval_params=eval_params,
                        payload_spec=MASK_SPEC, codec=codec,
                        downlink=_prob_downlink(downlink_bits))


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


def _mask_aggregate(state, payloads, wn, participation):
    theta = plds.batched_packed_mean(payloads, wn)
    return MaskState(masking.scores_from_theta(theta), state.floats,
                     state.weights, state.round + 1)


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
        sc, os = state.scores, opt.init(state.scores)
        H = tu.leaves(data)[0].shape[0]
        for t in range(H):
            batch = tu.tree_map(lambda v: v[t], data)
            st = federated._trainable(sc)
            with torch.enable_grad():
                eff = masking.sample_effective(
                    masking.MaskedParams(state.weights, st, state.floats),
                    mode="threshold", tau=tau)
                loss = loss_fn(apply_fn(eff, batch), batch)
                (g,) = federated._grads(loss, (st,))
            with torch.no_grad():
                upd, os = opt.update(g, os, sc)
                sc = optlib.apply_updates(sc, upd)
        mask = tu.tree_map(lambda s: None if s is None else
                           (torch.sigmoid(s) > tau).to(torch.uint8), sc)
        metrics = {"loss": loss.detach(),
                   "sparsity": regularizer.sparsity(mask)}
        return plds.BitpackedMasks.from_masks(mask), metrics

    def eval_params(state, generator, u=None):
        mp = masking.MaskedParams(state.weights, state.scores, state.floats)
        return masking.sample_effective(mp, mode="threshold", tau=tau)

    return FedAlgorithm("fedmask", init=_mask_init(spec),
                        client_update=client_update,
                        aggregate=_mask_aggregate, eval_params=eval_params,
                        payload_spec=MASK_SPEC, codec=codec,
                        downlink=_SCORE_DOWNLINK)
