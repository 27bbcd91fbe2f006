"""Core mask-training primitives (the training half of
`repro.core.masking`).

The paper trains scores s over a frozen random network w:

    theta = sigmoid(s);  m ~ Bernoulli(theta);  y(x) = f(x; m * w)

with a straight-through estimator (dm/dtheta := 1).  Maskable leaves are
chosen by `MaskSpec`; norms, biases and embeddings stay float.

`masked_forward_tree` merges (weights, scores, floats) into one params
tree whose maskable leaves are `MaskedLeaf` bundles; the models route
those through the fused kernels (`repro_torch.models.layers`).  Every
mask is drawn from the counter hash at the leaf's stream coordinates
(seed, off), so the forward's mask of a leaf equals the bits
`sample_and_pack` packs for it under the same seed.

The serving half (`MaskIdentity`, `freeze_identity`, `FreezeCache`)
materializes a tenant's m * w once for decoding, and `final_mask` draws
the deployable artifact's mask.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import tree as tu
from repro_torch.kernels import ref as kref

Pytree = Any
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Frozen random weights and initial scores
# ---------------------------------------------------------------------------


def signed_constant_init(gen: torch.Generator, shape, fan_in: int,
                         dtype=torch.float32):
    """Paper §IV: weights ~ Uniform{-c, +c}, c = sqrt(2 / fan_in) (the
    std of Kaiming Normal), with c computed in `dtype` as the reference
    does."""
    c = torch.sqrt(torch.tensor(2.0 / max(fan_in, 1), dtype=dtype,
                                device=gen.device))
    sign = torch.randint(0, 2, tuple(shape), generator=gen,
                         device=gen.device).to(dtype) * 2 - 1
    return sign * c


def score_init(gen: torch.Generator, shape, dtype=torch.float32,
               p0: float = 0.5, jitter: float = 0.0):
    """Scores with sigmoid(s) ~ U[p0 - jitter, p0 + jitter] (the paper's
    theta ~ U[0, 1] at p0 = jitter = 0.5), or exactly logit(p0)."""
    if jitter > 0:
        u = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
        u.uniform_(max(p0 - jitter, 1e-4), min(p0 + jitter, 1 - 1e-4),
                   generator=gen)
        return torch.log(u) - torch.log1p(-u)
    p = min(max(p0, 1e-4), 1 - 1e-4)
    return torch.full(tuple(shape), math.log(p) - math.log1p(-p),
                      dtype=dtype, device=gen.device)


def logit(theta: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    theta = torch.clamp(theta, eps, 1.0 - eps)
    return torch.log(theta) - torch.log1p(-theta)


class _STE(torch.autograd.Function):
    """Forward the given mask, pass the gradient straight to theta."""

    @staticmethod
    def forward(ctx, theta, mask):
        return mask.to(theta.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def ste_bernoulli(theta: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """m = 1[u < theta] in theta's dtype, straight-through: dm/dtheta := 1
    (u is the caller's uniform noise and gets no gradient)."""
    return _STE.apply(theta, u < theta)


def ste_threshold(theta: torch.Tensor, tau: float) -> torch.Tensor:
    """The deterministic mask m = 1[theta > tau] (FedMask), with the STE."""
    return _STE.apply(theta, theta > tau)


# ---------------------------------------------------------------------------
# MaskSpec: which leaves are masked
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Mask every >= 2-D leaf except paths matching `float_patterns`
    (case-insensitive; a one-letter pattern must match a whole path
    component, longer ones match as substrings) and, unless
    `mask_embeddings`, embedding tables."""
    float_patterns: tuple = ("norm", "bias", "scale", "router", "a_param",
                             "dt", "A_log", "D", "embed_float")
    mask_embeddings: bool = False
    min_ndim: int = 2

    def is_masked(self, path: str, leaf) -> bool:
        lp = path.lower()
        parts = lp.split("/")
        for p in self.float_patterns:
            pl = p.lower()
            if (len(pl) > 1 and pl in lp) or pl in parts:
                return False
        if not self.mask_embeddings and ("embed" in lp or "unembed" in lp
                                         or "lm_head" in lp):
            return False
        return getattr(leaf, "ndim", 0) >= self.min_ndim


def split_params(params: Pytree, spec: MaskSpec) -> Pytree:
    """A tree of bools mirroring `params`: which leaves `spec` masks."""
    paths = tu.flatten_with_paths(params)
    return tu.unflatten(tu.flatten(params)[1],
                        [spec.is_masked(p, l) for p, l in paths])


@dataclasses.dataclass
class MaskedParams:
    """weights: frozen random values (None at float leaves);
    scores: trainable logits (None at float leaves);
    floats: trainable float leaves (None at masked leaves)."""
    weights: Pytree
    scores: Pytree
    floats: Pytree


def init_masked(gen: torch.Generator, params_like: Pytree, spec: MaskSpec,
                fan_in_fn: Callable = None, score_dtype=torch.float32,
                weight_dtype=torch.bfloat16) -> MaskedParams:
    """Split a template params tree: masked leaves get signed-constant
    weights and logit-uniform scores, float leaves keep their value.
    As in the reference, the default fan-in is a leaf's first dimension
    (the layer count for a layer-stacked leaf)."""
    weights, scores, floats = [], [], []
    paths = tu.flatten_with_paths(params_like)
    for path, leaf in paths:
        if spec.is_masked(path, leaf):
            fan_in = leaf.shape[0] if leaf.ndim >= 2 else leaf.numel()
            if fan_in_fn is not None:
                fan_in = fan_in_fn(leaf)
            weights.append(signed_constant_init(gen, leaf.shape, fan_in,
                                                weight_dtype))
            scores.append(score_init(gen, leaf.shape, score_dtype, p0=0.5,
                                     jitter=0.5))
            floats.append(None)
        else:
            weights.append(None)
            scores.append(None)
            floats.append(leaf)
    tdef = tu.flatten(params_like)[1]
    mk = lambda lst: tu.unflatten(tdef, lst)
    return MaskedParams(mk(weights), mk(scores), mk(floats))


def sample_effective(mp: MaskedParams,
                     generator: Optional[torch.Generator] = None,
                     mode: str = "sample", tau: float = 0.5,
                     u: Optional[list] = None) -> Pytree:
    """Effective params: m * w at masked leaves (in w's dtype), the float
    leaves as they are.

    mode: "sample"    -> m ~ Bern(sigmoid(s)) with the STE (training)
          "threshold" -> m = 1[sigmoid(s) > tau]      (eval, FedMask)
          "expected"  -> m = sigmoid(s)               (the mean network)

    The uniforms of mode "sample" come from `generator`, one draw of the
    leaf's shape per masked leaf in flatten order, or are injected as
    `u` (a list over the masked leaves), as `final_mask` takes them.
    This is the host-simulation path: the masks are drawn here, not from
    the fused kernels' hash stream."""
    it = iter(u) if u is not None else None

    def one(w, s, f):
        if w is None:
            return f
        theta = torch.sigmoid(s.float())
        if mode == "sample":
            uu = next(it).to(s.device) if it is not None else torch.rand(
                s.shape, generator=generator, device=s.device)
            m = ste_bernoulli(theta, uu)
        elif mode == "threshold":
            m = ste_threshold(theta, tau)
        elif mode == "expected":
            m = theta
        else:
            raise ValueError(mode)
        return m.to(w.dtype) * w

    return tu.tree_map(one, mp.weights, mp.scores, mp.floats)


# ---------------------------------------------------------------------------
# Masked execution: the (w, s, seed, off) convention shared with the uplink
# ---------------------------------------------------------------------------


def mask_stream_seed(step, dev, leaf_idx: int, cohort, run_seed=0) -> int:
    """The (run, step, shard, leaf, cohort) -> uint32 seed convention of
    the counter-based mask sampler, shared by the forward and the round
    uplink (uint32 arithmetic on Python ints)."""
    base = ((int(step) & _M32) * 0x9E3779B9 & _M32) \
        ^ (((int(dev) + 1) & _M32) * 0x85EBCA6B & _M32) \
        ^ (leaf_idx * 0xC2B2AE35 & _M32) \
        ^ ((int(run_seed) & _M32) * 0x7FEB352D & _M32)
    return (base + (int(cohort) & _M32) * 0x01000193) & _M32


def stream_offsets(lead, K: int, N: int) -> np.ndarray:
    """uint32 stream offsets b*K*N mod 2**32 of the (K, N) blocks of a
    leaf of shape lead + (K, N), shaped `lead`."""
    nblk = int(np.prod(lead, dtype=np.int64))
    return ((np.arange(nblk, dtype=np.uint64) * np.uint64(K * N))
            & np.uint64(_M32)).astype(np.uint32).reshape(tuple(lead))


@dataclasses.dataclass
class MaskedLeaf:
    """One maskable tensor on the fused path: frozen weights `w`, score
    logits `s` and the hash-stream coordinates of each trailing (K, N)
    block.  For a leaf of shape lead + (K, N), `seed` and `off` are
    uint32 numpy arrays of shape `lead` (block b samples at flat index
    off[b] = b*K*N mod 2**32 of the leaf's stream); `block(i)` slices the
    leading axis, so layer l of a stacked (L, E, K, N) expert leaf has the
    (E,) seeds and offsets (l*E + e)*K*N of one grouped launch.  `s` may
    also be a sequence of per-layer tensors (the train step makes each
    layer's block its own autograd leaf).

    `n_logical` is the row length of the stream the (K, N) blocks are
    cut from: mask (row, col) of a block is drawn at off + row*n_logical
    + col, so a block of columns c0.. of a wider leaf, with `off` moved
    by c0, draws that leaf's masks bit for bit.  None: the block's own
    N.  `layout`, when set, is a rank's placement of the leaf on a mesh
    (`launch.partition.BlockLayout`): `w` and `s` are then the rank's
    blocks, and `layers.masked_dense_apply` runs the layout's
    partitioned product."""
    w: Any
    s: Any
    seed: Any
    off: Any
    mode: str = "sample"
    tau: float = 0.5
    n_logical: Optional[int] = None
    layout: Any = None

    @classmethod
    def build(cls, w, s, seed: int, mode: str = "sample", tau: float = 0.5):
        lead = tuple(w.shape[:-2])
        K, N = w.shape[-2:]
        seed = np.full(lead, int(seed) & _M32, dtype=np.uint32)
        return cls(w, s, seed, stream_offsets(lead, K, N), mode, tau)

    def block(self, i: int) -> "MaskedLeaf":
        return MaskedLeaf(self.w[i], self.s[i], self.seed[i], self.off[i],
                          self.mode, self.tau, self.n_logical, self.layout)


def materialize_leaf(leaf: MaskedLeaf) -> torch.Tensor:
    """Effective weights m * w for a MaskedLeaf with the fused kernels'
    masks (same stream, same offsets, the leaf's `n_logical`) and
    straight-through grads to s."""
    K, N = leaf.w.shape[-2:]
    s = leaf.s if isinstance(leaf.s, torch.Tensor) else torch.stack(
        list(leaf.s))
    theta = torch.sigmoid(s.float())
    if leaf.mode == "threshold":
        m = kref.threshold_mask(s, leaf.tau)
    else:
        dev = s.device
        off = torch.as_tensor(leaf.off.astype(np.int64), device=dev)
        seed = torch.as_tensor(leaf.seed.astype(np.int64), device=dev)
        idx = off[..., None, None] + kref.flat_index(
            K, N, 0, N if leaf.n_logical is None else leaf.n_logical, dev)
        u = kref.hash_uniform(idx, seed[..., None, None])
        m = (u < theta).to(torch.uint8)
    return _STE.apply(theta, m).to(leaf.w.dtype) * leaf.w


def leaves_with_paths(tree: Pytree) -> list:
    """[(path, leaf)] of the non-None leaves in flatten order, paths as
    the reference's `_path_str` writes them ('/'-joined dict keys and
    sequence indices)."""
    return [(p, l) for p, l in tu.flatten_with_paths(tree) if l is not None]


def masked_forward_tree(mp: MaskedParams, seed_fn: Callable,
                        mode: str = "sample", tau: float = 0.5) -> Pytree:
    """Merge MaskedParams into one params tree: maskable leaves become
    `MaskedLeaf`s seeded by `seed_fn(leaf_idx)`, where leaf indices
    enumerate the flattened tree with None leaves counted — the round
    uplink's enumeration."""
    flat_w, tdef = tu.flatten(mp.weights)
    flat_s = tu.leaves(mp.scores)
    flat_f = tu.leaves(mp.floats)
    out = []
    for i, (w, s, f) in enumerate(zip(flat_w, flat_s, flat_f)):
        out.append(f if w is None else
                   MaskedLeaf.build(w, s, seed_fn(i), mode, tau))
    return tu.unflatten(tdef, out)


def hash_effective(mp: MaskedParams, seed_fn: Callable,
                   mode: str = "sample", tau: float = 0.5) -> Pytree:
    """Materialized twin of `masked_forward_tree`: effective params
    m * w with the same hash-stream masks as the fused kernels."""
    return tu.tree_map(
        lambda p: materialize_leaf(p) if isinstance(p, MaskedLeaf) else p,
        masked_forward_tree(mp, seed_fn, mode, tau))


def freeze_for_decode(tree: Pytree) -> Pytree:
    """Materialize every `MaskedLeaf` of a forward tree once for a decode
    session, so decoding consumes plain tensors and never resamples a
    mask; float leaves pass through.  Runs without autograd: a frozen
    tree holds m * w only, not the graph back to the scores."""
    with torch.no_grad():
        return tu.tree_map(
            lambda p: materialize_leaf(p) if isinstance(p, MaskedLeaf)
            else p, tree)


# ---------------------------------------------------------------------------
# Serving: per-tenant mask identities and the bounded freeze-cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MaskIdentity:
    """Hashable identity of one tenant's sub-network: the stream
    coordinates that regenerate its mask over the shared frozen `w`.

      seed:   the artifact's run seed (`mask_stream_seed(..., run_seed)`)
      mode:   "threshold" (the deployed FedMask-style mask, the serve
              launcher's convention) or "sample"
      tau:    threshold of mode "threshold"
      cohort: stream cohort coordinate (0 for a single artifact)
      tag:    tells apart tenants with equal coordinates but their own
              score trees (else the freeze-cache would alias them)

    The freeze-cache key and the serving engine's per-slot identity."""
    seed: int
    mode: str = "threshold"
    tau: float = 0.5
    cohort: int = 0
    tag: str = ""


def freeze_identity(mp: MaskedParams, ident: MaskIdentity,
                    scores: Optional[Pytree] = None) -> Pytree:
    """The decode tree of one tenant over the shared `MaskedParams`: the
    forward tree at the identity's stream coordinates (step 0, shard 0),
    frozen once.  `scores` substitutes a tenant's own score tree over the
    same weights."""
    if scores is not None:
        mp = MaskedParams(mp.weights, scores, mp.floats)
    seed_fn = lambda i: mask_stream_seed(0, 0, i, ident.cohort,
                                         run_seed=ident.seed)
    return freeze_for_decode(masked_forward_tree(
        mp, seed_fn, mode=ident.mode, tau=ident.tau))


class FreezeCache:
    """Bounded exact-LRU cache of frozen decode trees, so serving holds
    one copy of `w` and at most `capacity` materialized trees however
    many tenants rotate through.

    `get(key)` returns the cached tree on a hit (making it most recently
    used) or builds it with `build_fn(key)` on a miss, evicting the least
    recently used entry when occupancy would exceed `capacity`.  An
    evicted tree is dropped here; its device memory is freed once no
    slot holds it.  `hits` / `misses` / `evictions` count the calls."""

    def __init__(self, build_fn: Callable[[Any], Pytree], capacity: int):
        if capacity < 1:
            raise ValueError(f"FreezeCache capacity must be >= 1, "
                             f"got {capacity}")
        self._build = build_fn
        self.capacity = int(capacity)
        self._store = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key) -> Pytree:
        if key in self._store:
            self._store.move_to_end(key)
            self.hits += 1
            return self._store[key]
        self.misses += 1
        tree = self._build(key)
        self._store[key] = tree
        if len(self._store) > self.capacity:
            self._store.popitem(last=False)
            self.evictions += 1
        return tree

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key) -> bool:
        return key in self._store

    def keys(self) -> list:
        """Resident keys in LRU -> MRU order (eviction order)."""
        return list(self._store.keys())

    def stats(self) -> dict:
        return {"capacity": self.capacity, "occupancy": len(self._store),
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}


def masked_delta_bytes(mp: MaskedParams) -> int:
    """Bytes of one frozen tree's masked leaves (m * w at w's dtype): a
    resident tenant's device-memory delta."""
    return sum(l.numel() * l.element_size() for l in tu.leaves(mp.weights)
               if l is not None)


def mask_artifact_bytes(mp: MaskedParams) -> int:
    """Wire size of one tenant's packed 1-bit mask (uint32 words per
    leaf): what a tenant costs to ship."""
    return sum(4 * ((l.numel() + 31) // 32) for l in tu.leaves(mp.scores)
               if l is not None)


def final_mask(mp: MaskedParams, generator: Optional[torch.Generator] = None,
               u: Optional[list] = None) -> Pytree:
    """The deployable mask m ~ Bern(sigmoid(s)): uint8 {0,1} leaves where
    scores exist, None elsewhere.  The uniforms come from `generator`,
    one draw per leaf in flatten order, or are injected as `u` (a list
    over the non-None leaves), as `aggregation.quantize_theta` takes
    them."""
    it = iter(u) if u is not None else None

    def one(s):
        if s is None:
            return None
        uu = next(it).to(s.device) if it is not None else torch.rand(
            s.shape, generator=generator, device=s.device)
        return (uu < torch.sigmoid(s.float())).to(torch.uint8)

    with torch.no_grad():
        return tu.tree_map(one, mp.scores)


def scores_from_theta(theta_tree: Pytree) -> Pytree:
    """Client-side round start: s = logit(theta) (eq. 4)."""
    return tu.tree_map(
        lambda t: None if t is None else logit(t.float()), theta_tree)


def count_params(tree: Pytree) -> int:
    return sum(l.numel() for l in tu.leaves(tree) if l is not None)

