"""Federated rounds in host simulation, the paper-faithful path
(`repro.core.federated`), and the deployable artifact.

The protocol of a round t (Sec. II of the paper):
  1. The server holds the global probability mask theta(t) (and the
     float leaves).
  2. Each participating client i: s_i <- logit(theta(t))          (eq. 4)
  3. H local mini-batch steps on the scores with the STE and the
     entropy-proxy regularizer                               (eqs. 6, 7, 12)
  4. The uplink mask m_i ~ Bern(sigmoid(s_i)).
  5. The server: theta(t+1) = the weighted mean of the masks      (eq. 8)

A local step trains through `masking.sample_effective`, which draws the
mask from a `torch.Generator` and forms m * w as plain tensors.  The
round itself is `api.protocol.run_round` (`make_round_fn`).

The artifact is the paper's end product, "seed + binary mask": the seed
that regenerates the frozen random weights and one bitpacked mask per
masked leaf, about n/8 bytes in all, plus the float leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import masking, regularizer
from repro_torch.core import tree as tu
from repro_torch.optim import optimizers as optlib

Pytree = Any


class ServerState(NamedTuple):
    theta: Pytree      # global probability mask (None at float leaves)
    floats: Pytree     # averaged float leaves (None at masked leaves)
    weights: Pytree    # frozen random weights (regenerable from seed)
    seed: int          # the init seed (the only weight payload), uint32
    round: int


@dataclasses.dataclass(frozen=True)
class FedConfig:
    lam: float = 1.0            # regularization strength lambda
    local_steps: int = 3        # H: local mini-batch iterations per round
    lr: float = 0.1             # score learning rate
    float_lr: float = 0.01      # lr of the float leaves
    optimizer: str = "sgd"      # "sgd" | "momentum" | "adam"
    bayesian: bool = False      # FedPM's beta aggregation
    train_floats: bool = True


def init_server(gen: torch.Generator, params_like: Pytree,
                spec: masking.MaskSpec) -> ServerState:
    """Server state on `gen`'s device: frozen weights and initial scores
    drawn from `gen`, theta = sigmoid(scores), the float leaves copied.
    The seed is `gen`'s initial seed, which regenerates the weights from
    a fresh generator."""
    mp = masking.init_masked(gen, params_like, spec)
    theta = tu.tree_map(
        lambda s: None if s is None else torch.sigmoid(s.float()), mp.scores)
    floats = tu.tree_map(lambda f: None if f is None else f.clone(),
                         mp.floats)
    return ServerState(theta=theta, floats=floats, weights=mp.weights,
                       seed=gen.initial_seed() & 0xFFFFFFFF, round=0)


def _make_opt(name: str, lr: float) -> optlib.Optimizer:
    if name == "sgd":
        return optlib.sgd(lr)
    if name == "momentum":
        return optlib.momentum(lr)
    if name == "adam":
        return optlib.adam(lr)
    raise ValueError(name)


def _grads(loss, trees):
    """d loss / d leaf for every non-None leaf of each tree (zeros where a
    leaf does not reach the loss), in the trees' structure."""
    flat = [[l for l in tu.leaves(t) if l is not None] for t in trees]
    gs = iter(torch.autograd.grad(loss, [l for f in flat for l in f],
                                  allow_unused=True))
    out = []
    for t in trees:
        out.append(tu.tree_map(
            lambda l: None if l is None else
            (lambda g: torch.zeros_like(l) if g is None else g)(next(gs)), t))
    return out


def _trainable(tree):
    return tu.tree_map(
        lambda l: None if l is None else l.detach().requires_grad_(), tree)


def make_client_update(apply_fn: Callable, loss_fn: Callable,
                       cfg: FedConfig):
    """One client's local update.

    apply_fn(effective_params, batch) -> model outputs
    loss_fn(outputs, batch) -> scalar data loss (e.g. mean CE)

    Returns fn(weights, floats, theta, data, generator=None,
    uniforms=None) -> (uint8 mask tree, new floats, metrics), where
    `data` is a tree of tensors with a leading axis of cfg.local_steps
    (one mini-batch a local step).  The mask uniforms come from
    `generator`: each step draws one per masked leaf (`sample_effective`),
    then the uplink mask one per leaf (`final_mask`); or `uniforms`
    injects them, a list of local_steps + 1 such lists."""
    opt = _make_opt(cfg.optimizer, cfg.lr)
    fopt = _make_opt(cfg.optimizer, cfg.float_lr)

    def client(weights, floats, theta, data, generator=None, uniforms=None):
        scores = masking.scores_from_theta(theta)   # eq. (4)
        ostate = opt.init(scores)
        fstate = fopt.init(floats)
        for t in range(cfg.local_steps):
            batch = tu.tree_map(lambda v: v[t], data)
            sc = _trainable(scores)
            fl = _trainable(floats) if cfg.train_floats else floats
            with torch.enable_grad():
                eff = masking.sample_effective(
                    masking.MaskedParams(weights, sc, fl), generator,
                    mode="sample",
                    u=None if uniforms is None else uniforms[t])
                data_loss = loss_fn(apply_fn(eff, batch), batch)
                reg = regularizer.entropy_proxy(sc)
                loss = data_loss + cfg.lam * reg
                grads = _grads(loss, (sc, fl) if cfg.train_floats else (sc,))
            with torch.no_grad():
                upd, ostate = opt.update(grads[0], ostate, scores)
                scores = optlib.apply_updates(scores, upd)
                if cfg.train_floats:
                    updf, fstate = fopt.update(grads[1], fstate, floats)
                    floats = optlib.apply_updates(floats, updf)
        mask = masking.final_mask(
            masking.MaskedParams(weights, scores, floats), generator,
            None if uniforms is None else uniforms[cfg.local_steps])
        metrics = {
            "loss": loss.detach(), "data_loss": data_loss.detach(),
            "reg": reg.detach(),
            "uplink_bpp": regularizer.empirical_entropy(mask),
            "sparsity": regularizer.sparsity(mask),
        }
        return mask, floats, metrics

    return client


def make_round_fn(apply_fn: Callable, loss_fn: Callable, cfg: FedConfig):
    """The full round over K clients: `round_fn(server, data (K, H, ...),
    participation bool (K,), sizes f32 (K,), generator=None,
    uniforms=None) -> (server, metrics)`.  It is the `fedpm_reg` (or, at
    lam = 0, `fedpm`) algorithm's round of the `api` engine, so the
    host-sim loop and every registered algorithm run one code path."""
    from repro_torch.api import algorithms as _algos   # api -> core

    algo = _algos._fedpm_family(
        "fedpm_reg" if cfg.lam > 0 else "fedpm", apply_fn, loss_fn, cfg=cfg)
    return algo.round


def make_eval_fn(apply_fn: Callable, metric_fn: Callable,
                 mode: str = "sample", n_samples: int = 1):
    """Evaluation of the global model: `eval_fn(server, batch,
    generator=None, uniforms=None)` -> the mean of metric_fn over
    n_samples networks sampled (or thresholded) from theta; `uniforms`
    injects one list a sample."""
    @torch.no_grad()
    def eval_fn(server: ServerState, batch, generator=None, uniforms=None):
        scores = masking.scores_from_theta(server.theta)
        mp = masking.MaskedParams(server.weights, scores, server.floats)
        vals = [metric_fn(apply_fn(masking.sample_effective(
            mp, generator, mode=mode,
            u=None if uniforms is None else uniforms[i]), batch), batch)
            for i in range(n_samples)]
        return torch.stack(vals).mean()

    return eval_fn


def final_artifact(server: ServerState,
                   generator: Optional[torch.Generator] = None,
                   u: Optional[list] = None) -> dict:
    """The deployable artifact {"seed", "masks": {path: (words, shape)},
    "floats"}: a mask drawn from theta (uniforms from `generator`, or
    injected as `u`, one tensor per masked leaf in flatten order), packed
    leaf by leaf (one pack launch per masked leaf on the card)."""
    from repro_torch.api import payloads   # api -> core

    scores = masking.scores_from_theta(server.theta)
    mask = masking.final_mask(
        masking.MaskedParams(server.weights, scores, server.floats),
        generator, u)
    payload = payloads.BitpackedMasks.from_masks(mask, server.floats)
    return {"seed": server.seed, "masks": payload.as_path_dict(),
            "floats": server.floats}
