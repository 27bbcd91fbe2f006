"""The federated train and round steps (the reference's
`repro.launch.steps`), on one device or on a mesh of ranks
(`launch.mesh`).

State layout as in the reference: `scores`, `floats`, `opt_m` (and
`opt_v` for adam) carry a leading cohort axis C; the frozen `weights`
have none; `step` counts train steps and rounds, and is the tick every
mask stream is keyed by.

* `make_train_step` — one local mini-batch score update per cohort on
  the fused path: the forward consumes a `masked_forward_tree`, every
  masked projection runs the masked-matmul kernels, and scores get the
  straight-through gradient plus lam times the eq. 12 entropy proxy's.
  On a mesh each rank updates its block (`launch.partition`: FSDP
  gathers over "data", kernels 1-3 on column blocks over "model",
  kernels 5-7 on the rank's experts, kernels 8-9 on its conv channels).
  `StepConfig.microbatch` = M splits each cohort's batch into M
  contiguous chunks, one mask-stream tick each (step * M + j), and
  averages their gradients in f32 (on a mesh a rank runs its rows as
  pieces inside those chunks); `chunk_kv` chunks attention over its
  keys; `score_dtype` (that of `init_fed_state`: a state of another
  score type raises) keeps scores and moments in bf16, updated in f32 a
  piece at a time and stored once in their type.
* `make_round_step` — the paper's communication event: each cohort's
  scores become packed mask words through the fused `sample_and_pack`
  kernel, theta is the (survivor-weighted) mean of the words, crosses
  the optional k-bit downlink, and resets every cohort's scores; the
  codec meters each cohort's pooled words.  `packed_masks=False` is the
  unpacked bf16 baseline.  On a mesh (`fed_state_shardings`, each rank
  holding its block) the words cross ranks through one all-gather over
  "pod".
* `make_fedavg_step` — the float reference (`--algo fedavg`): one plain
  autograd step of the float params with f32 momentum, no masks and no
  kernel of the port.
* `make_serve_step` — one decode token of the deployed artifact:
  `api.decode_step` itself (the dry run's decode cells and the serving
  example run it); `make_prefill_step` the last position's logits of a
  prompt (the dry run's prefill cells).  On a mesh both run a rank's
  blocks (`launch.partition.ServePlan`: projections on column blocks,
  the KV cache split by heads or by positions).
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
import math
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.api import codecs as codecs_lib
from repro_torch.api import payloads as plds
from repro_torch.core import aggregation, masking, regularizer
from repro_torch.core import tree as tu
from repro_torch.core.masking import MaskedLeaf, MaskedParams
from repro_torch.kernels import ref as kref
from repro_torch.launch import partition
from repro_torch.launch import sharding as shd

Pytree = Any


@dataclasses.dataclass(frozen=True)
class StepConfig:
    lam: float = 1.0
    lr: float = 0.1
    float_lr: float = 0.01
    momentum: float = 0.9
    chunk_kv: Optional[int] = None   # attention over KV chunks (long seq)
    packed_masks: bool = True        # bitpacked uplink (False: bf16 masks)
    score_dtype: Any = torch.float32  # the state's (`init_fed_state`)
    microbatch: int = 1              # gradient-accumulation chunks
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
                   score_dtype=torch.float32, optimizer: str = "momentum"):
    """Fed state on `gen`'s device; every cohort starts from the same
    scores and floats.  Scores and their moments (`opt_m`, adam's
    `opt_v`) are of `score_dtype` (f32, or bf16: half the mask state)."""
    mp = masking.init_masked(gen, api.init_params(gen), spec,
                             score_dtype=score_dtype)

    def rep(t):   # one cohort holds the init's tensors themselves
        if t is None:
            return None
        return t[None] if C == 1 else t[None].repeat((C,) + (1,) * t.ndim)

    scores = tu.tree_map(rep, mp.scores)
    zeros = lambda tree: tu.tree_map(
        lambda x: None if x is None else torch.zeros_like(x), tree)
    state = {"scores": scores, "floats": tu.tree_map(rep, mp.floats),
             "weights": mp.weights, "opt_m": zeros(scores), "step": 0}
    if optimizer == "adam":
        state["opt_v"] = zeros(scores)
    return state


def n_cohorts(mesh) -> int:
    return mesh.shape["pod"] if "pod" in mesh.axis_names else 1


def fed_state_shardings(state_shapes, mesh):
    """Shardings of the federated state (its tensors' shapes are all that
    is read: meta or fake tensors do): the cohort axis on "pod", each
    leaf's body by `sharding.param_spec`, the step replicated."""
    has_pod = "pod" in mesh.axis_names

    def score_like(tree):
        def one(p, leaf):
            if leaf is None:
                return None
            # leading cohort axis (+ possibly a layer-stack axis after)
            sd = 1 + (0 if any(t in p.lower() for t in
                               ("embed", "final_norm", "lm_head",
                                "pos_embed")) else 1)
            sd = min(sd, max(len(leaf.shape) - 1, 0))
            ps = shd.param_spec(p, leaf.shape, mesh, scan_dims=sd)
            spec = list(ps) + [None] * (len(leaf.shape) - len(ps))
            if has_pod:
                spec[0] = "pod"
            return shd.NamedSharding(mesh, shd.P(*spec))
        return shd.tree_map_with_path(one, tree)

    out = {
        "scores": score_like(state_shapes["scores"]),
        "floats": score_like(state_shapes["floats"]),
        "weights": shd.tree_param_shardings(state_shapes["weights"], mesh),
        "opt_m": score_like(state_shapes["opt_m"]),
        "step": shd.replicated(mesh),
    }
    if "opt_v" in state_shapes:
        out["opt_v"] = score_like(state_shapes["opt_v"])
    return out


def _check_score_dtype(state, cfg: StepConfig):
    """The steps update the state's scores in place, in their own type,
    where the reference's round returns them cast to `cfg.score_dtype`:
    so a state whose scores are of another type than `cfg.score_dtype`
    raises rather than keep a type the config does not name."""
    got = {s.dtype for s in tu.leaves(state["scores"]) if s is not None}
    if got - {cfg.score_dtype}:
        raise ValueError(f"the state's scores are {sorted(map(str, got))} "
                         f"but StepConfig.score_dtype is "
                         f"{cfg.score_dtype}: give both the same type")


def _blocks(t: torch.Tensor) -> list:
    """The per-layer blocks of a leaf: views along its leading (layer)
    axis, or the leaf itself when it is one (K, N) matrix.  A layer's
    block of a stacked expert leaf is its whole (E, K, N) slice, the
    operand of one grouped launch."""
    return [t] if t.ndim == 2 else list(t.unbind(0))


def _grad_blocks(s: torch.Tensor):
    """The per-layer blocks of a cohort's score leaf, each an autograd
    leaf of its own (views of the state's storage), so each block's
    gradient lands in its own `.grad` and no stacked gradient buffer is
    built; a (K, N) leaf is one block."""
    blocks = [b.detach().requires_grad_() for b in _blocks(s)]
    return blocks[0] if s.ndim == 2 else blocks


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


ADAM_BETAS = (0.9, 0.999)


def _update_f32(cfg, g, s, m, v, coef, bc):
    """One piece of the f32 score update, in place: g += the proxy's
    gradient, then momentum (m = momentum m + g; s -= lr m) or adam."""
    b1, b2 = ADAM_BETAS
    if cfg.lam:
        regularizer.entropy_proxy_grad_(g, s, coef)
    if v is None:
        m.mul_(cfg.momentum).add_(g)
        s.sub_(cfg.lr * m)
    else:
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * (g * g))
        s.sub_(cfg.lr * (m / bc[0]) / (torch.sqrt(v / bc[1]) + cfg.adam_eps))


def _low_grad(g, s, coef) -> torch.Tensor:
    """A piece of the gradient of loss + lam * proxy w.r.t. bf16 scores,
    as the reference's autodiff forms it: the proxy's f32 gradient
    rounded to bf16, plus the bf16 straight-through gradient g, in f32
    (the sum's own rounding to bf16 is left to the consumer)."""
    sig = torch.sigmoid(s.float())
    return g.float() + (coef * sig * (1.0 - sig)).to(s.dtype).float()


def _update_low(cfg, g, s, m, v, bc, g_low: bool):
    """One piece of the update of bf16 scores and moments, in the
    rounding of the reference's jitted step on the CPU (its optimized
    HLO): a Python constant times a bf16 tensor is a product with the
    constant rounded to bf16, and a bf16 result is rounded where a bf16
    op consumes it or it is stored, but kept in f32 where an f32 op
    consumes it.  g: where `g_low` (one batch) the `_low_grad` sum, which
    momentum and adam's m take rounded and adam's v unrounded; else the
    f32 microbatch mean.  m, v and s are each stored once in their type
    (round to nearest even)."""
    lo = s.dtype
    r = lambda x: x.to(lo).float()
    k = lambda c: float(torch.tensor(c, dtype=lo))   # the constant in bf16
    b1, b2 = ADAM_BETAS
    gr = r(g) if g_low else g
    if v is None:
        pm = k(cfg.momentum) * m.float()
        m.copy_((r(pm) if g_low else pm) + gr)
        s.copy_(s.float() - r(k(cfg.lr) * m.float()))
    else:
        pm = k(b1) * m.float()
        # one batch: a bf16 sum, which the score step reads unrounded;
        # microbatches: an f32 sum cast to bf16, which it reads rounded
        mf = (r(pm) + r(k(1 - b1) * gr) if g_low else pm + (1 - b1) * g)
        m.copy_(mf)
        if not g_low:
            mf = m.float()
        v.copy_(r(k(b2) * v.float()) + (1 - b2) * (g * g))
        s.copy_(s.float() - cfg.lr * (mf / bc[0])
                / (torch.sqrt(v.float() / bc[1]) + cfg.adam_eps))


def make_train_step(api, cfg: StepConfig, mesh=None, state_sh=None):
    """(state, batch) -> (state, {"loss"}); batch["tokens"]: (C, B, S)
    (and any other (C, B, ...) entries the family reads).  With
    `cfg.microbatch` = M > 1 each cohort's batch runs as M contiguous
    chunks of B / M, chunk j's masks drawn at stream tick step * M + j;
    the score and float gradients are summed over the chunks in f32 and
    divided by M (f32 scores sum in their `.grad`, bf16 ones in an f32
    buffer a block), the loss is the chunks' mean, and the entropy
    proxy's gradient is added once to the mean.

    With a `launch.mesh.Mesh` and the state's shardings `state_sh`
    (`fed_state_shardings`; both or neither), `state` is this rank's
    block of the global state (`runtime.elastic.reshard_server`) and
    `batch` its block of the global batch (its pod's cohorts, its "data"
    rows, alike on every "model" rank); the step runs the global step's
    semantics partitioned (`launch.partition`), updates the blocks in
    place and returns the global mean loss on every rank.  Cohort c of
    the rank keys its mask stream by its global index, the proxy's n is
    the global score count a cohort, and each cohort's gradient is the
    mean of its data ranks'.  With M > 1 the rank runs its rows as
    pieces that each lie inside one global chunk (`partition.
    batch_pieces`), each at its chunk's tick, their gradients summed in
    f32 and divided by the piece count, the loss their mean.  A MoE
    layer's routing groups (chunks, or blocks of them under
    `moe_block_dispatch`) that neither lie inside one data rank nor cover
    whole data ranks do not run (`partition.check_train` raises
    NotImplementedError on the first call)."""
    b1, b2 = ADAM_BETAS
    M = cfg.microbatch
    if (mesh is None) != (state_sh is None):
        raise ValueError("make_train_step: give both mesh and state_sh, "
                         "or neither")
    if mesh is not None:
        partition.check_train(api, cfg)

    def cohort_update(state, c, cohort, batch_c, plan):
        step = state["step"]
        scores_c = tu.tree_map(lambda s: None if s is None else s[c],
                               state["scores"])
        floats_c = tu.tree_map(
            lambda f: None if f is None else
            f[c].detach().requires_grad_(), state["floats"])
        mp = MaskedParams(state["weights"], scores_c,
                          floats_c if plan is None
                          else plan.gather_floats(floats_c))
        grad_s = [None if s is None else _grad_blocks(s)
                  for s in tu.leaves(scores_c)]
        blocks = [b for g in grad_s if g is not None
                  for b in ([g] if isinstance(g, torch.Tensor) else g)]
        dev = blocks[0].device
        # d(lam * (1/n) sum sigmoid(s)) / ds = (lam / n) sigmoid'(s)
        n = (sum(b.numel() for b in blocks) if plan is None
             else plan.n_scores)
        coef = (torch.tensor(cfg.lam, dtype=torch.float32) /
                torch.tensor(float(n), dtype=torch.float32)).to(dev)
        B = next(iter(batch_c.values())).shape[0]
        d, r = ((1, 0) if plan is None else
                (plan.mesh.shape["data"], plan.mesh.coords["data"]))
        rows, chunks = partition.batch_pieces(B, M, d, r)
        P = len(chunks)
        # over the pieces (mesh=None: the chunks): bf16 score blocks sum
        # their gradients (each with the proxy's, as the reference
        # differentiates each chunk's total) in an f32 buffer; f32 ones in
        # .grad, the floats in f32
        acc, f_acc, loss_sum = {}, {}, None
        for i_piece, j in enumerate(chunks):
            tick = step * M + j
            params = masking.masked_forward_tree(
                mp, lambda i: masking.mask_stream_seed(tick, 0, i, cohort,
                                                       run_seed=cfg.seed),
                mode=cfg.mask_mode, tau=cfg.tau)
            flat, tdef = tu.flatten(params)
            params = tu.unflatten(tdef, [
                dataclasses.replace(
                    p if plan is None else plan.place(i, p, B * d // M),
                    s=grad_s[i])
                if isinstance(p, MaskedLeaf) else p
                for i, p in enumerate(flat)])
            chunk = batch_c if P == 1 else {
                k: v[i_piece * rows:(i_piece + 1) * rows]
                for k, v in batch_c.items()}
            loss = api.loss(api.forward(params, chunk,
                                        chunk_kv=cfg.chunk_kv), chunk)
            loss.backward()
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            if M == 1:
                continue
            with torch.no_grad():
                for s in blocks:
                    if s.dtype == torch.float32:
                        continue
                    a = acc.setdefault(id(s), torch.zeros(
                        s.shape, dtype=torch.float32, device=dev))
                    g = (s.grad if s.grad is not None
                         else torch.zeros_like(s))
                    for ap, gp, sp, _ in _pieces(a, g, s, None):
                        ap.add_(_low_grad(gp, sp, coef))
                    s.grad = None
                for i, f in enumerate(tu.leaves(floats_c)):
                    if f is not None and f.grad is not None:
                        a = f_acc.get(i)
                        f_acc[i] = (f.grad.float() if a is None
                                    else a.add_(f.grad))
                        f.grad = None

        with torch.no_grad():
            moms = [m[c] for m in tu.leaves(state["opt_m"]) if m is not None]
            vels = ([v[c] for v in tu.leaves(state["opt_v"]) if v is not None]
                    if "opt_v" in state else [None] * len(moms))
            bc = None
            if "opt_v" in state:
                t = torch.tensor(float(step + 1), dtype=torch.float32)
                bc = ((1 - torch.tensor(b1, dtype=torch.float32) ** t).to(dev),
                      (1 - torch.tensor(b2, dtype=torch.float32) ** t).to(dev))
            score_leaves = [g for g in grad_s if g is not None]
            for s_leaf, m_leaf, v_leaf in zip(score_leaves, moms, vels):
                s_blocks = ([s_leaf] if isinstance(s_leaf, torch.Tensor)
                            else s_leaf)
                m_blocks = _blocks(m_leaf)
                v_blocks = ([None] * len(m_blocks) if v_leaf is None
                            else _blocks(v_leaf))
                for s, m, v in zip(s_blocks, m_blocks, v_blocks):
                    g = acc.pop(id(s), None)
                    if g is None:
                        g = (s.grad if s.grad is not None
                             else torch.zeros_like(s))
                    if P > 1:
                        g.div_(P)
                    for gp, sp, mp_, vp in _pieces(g, s, m, v):
                        if s.dtype == torch.float32:
                            _update_f32(cfg, gp, sp, mp_, vp, coef, bc)
                        elif M == 1:
                            _update_low(cfg, _low_grad(gp, sp, coef),
                                        sp, mp_, vp, bc, g_low=True)
                        else:
                            _update_low(cfg, gp, sp, mp_, vp, bc,
                                        g_low=False)
                    s.grad = None
                    del g
            for i, f in enumerate(tu.leaves(floats_c)):
                if f is None:
                    continue
                if i in f_acc:
                    f.copy_((f.float() - cfg.float_lr * (f_acc.pop(i) / P))
                            .to(f.dtype))
                elif f.grad is not None:
                    f.sub_(cfg.float_lr * f.grad)
                f.grad = None
        return loss_sum / P if P > 1 else loss_sum

    plan = None     # on a mesh: the rank's TrainPlan, built on the first call

    def train_step(state, batch):
        nonlocal plan
        _check_score_dtype(state, cfg)
        C = next(s for s in tu.leaves(state["scores"]) if s is not None
                 ).shape[0]
        if mesh is not None and plan is None:
            tokens = batch["tokens"]
            partition.check_train(api, cfg, mesh.shape["data"],
                                  tokens.shape[1] * mesh.shape["data"],
                                  tokens.shape[2])
            plan = partition.TrainPlan(mesh, state, state_sh)
        first = 0 if plan is None else plan.first_cohort(C)
        losses = [cohort_update(state, c, first + c,
                                {k: v[c] for k, v in batch.items()}, plan)
                  for c in range(C)]
        state["step"] += 1
        loss = torch.stack(losses).mean()
        return state, {"loss": loss if plan is None
                       else plan.mean_loss(loss)}

    return train_step


def make_round_step(api, cfg: StepConfig, mesh=None, state_sh=None,
                    codec=None):
    """(state, participation=None, downlink_u=None) -> (state, metrics).

    Each cohort's scores become mask words through the fused
    `sample_and_pack` kernel (`cfg.packed_masks`, the default), theta is
    the (survivor-weighted) mean of the words, crosses the optional k-bit
    downlink, and resets every cohort's scores in place; the codec meters
    each cohort's pooled words.  `packed_masks=False` is the unpacked
    baseline: the plain sampler's uint8 masks (`kref.sample_rows` /
    `threshold_rows`), their bf16 mean (an f32 weighted sum under
    participation), the codec metering the pooled bits.

    `participation` (C floats, 1 = the cohort's uplink arrived) makes
    theta the survivor-renormalized mean and meters survivors only.
    The k-bit downlink draws its uniforms from a torch.Generator seeded
    with `mask_stream_seed(step, 0, DOWNLINK_STREAM_LEAF, 0, run_seed)`
    (the reference keys threefry with the same value, which torch cannot
    reproduce); `downlink_u` injects them instead (one tensor per masked
    leaf, flatten order).  Metrics: bpp (eq. 13 bound), bpp_measured,
    bits_measured, downlink_bpp, downlink_bits: float32 tensors.

    With a `launch.mesh.Mesh` and the state's shardings `state_sh`
    (`fed_state_shardings`), `state` is this rank's block of the global
    state (`runtime.elastic.reshard_server`) and the round runs as the
    reference's `shard_map` does, shard by shard: every rank samples its
    own block of its local cohorts with `dev` = its linear mesh index,
    the packed words cross the wire through one `all_gather_into_tensor`
    over the "pod" group (1 bit a parameter and cohort, pod-major rows),
    the unpacked baseline through a bf16 `all_reduce` (16 bits), floats
    through an f32 mean (or survivor-weighted sum) over "pod", and
    `bits_measured` is summed over every rank.  As in the reference, a
    rank whose block is replicated over an axis still draws its own
    masks, so such replicas diverge; `bpp` is this rank's own; the
    downlink's generator, seeded alike everywhere, draws each rank's
    local shape."""
    codec = codecs_lib.get_codec(codec or "arithmetic")
    f32 = torch.float32
    if (mesh is None) != (state_sh is None):
        raise ValueError("make_round_step: give both mesh and state_sh, "
                         "or neither")
    has_pod = mesh is not None and "pod" in mesh.axis_names
    pod = mesh.group("pod") if has_pod else None
    npod = mesh.shape["pod"] if has_pod else 1

    def global_totals(flat_s):
        """(cohorts, masked parameters a cohort) of the global state."""
        if mesh is None:
            live = [s for s in flat_s if s is not None]
            return live[0].shape[0], sum(s[0].numel() for s in live)
        shapes = [sh.global_shape(tuple(s.shape)) for s, sh in zip(
            flat_s, tu.leaves(state_sh["scores"])) if s is not None]
        return shapes[0][0], sum(math.prod(sh[1:]) for sh in shapes)

    def round_step(state, participation=None, downlink_u=None):
        _check_score_dtype(state, cfg)
        step = state["step"]
        flat_s = tu.leaves(state["scores"])
        Cl = next(s for s in flat_s if s is not None).shape[0]
        dev = next(s for s in flat_s if s is not None).device
        C, n_glob = global_totals(flat_s)
        shard = mesh.device_index() if mesh is not None else 0
        part = wn = alive = wn_l = None
        if participation is not None:
            part = torch.as_tensor(participation, device=dev).to(f32)
            wn = part / torch.clamp(part.sum(), min=1.0)
            off = mesh.coords["pod"] * Cl if has_pod else 0
            alive, wn_l = part[off:off + Cl], wn[off:off + Cl]
        gen = None
        if cfg.downlink_bits and downlink_u is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(masking.mask_stream_seed(
                step, 0, DOWNLINK_STREAM_LEAF, 0, run_seed=cfg.seed))
        u_it = iter(downlink_u) if downlink_u is not None else None
        ones_c, parts, n_pool = None, [], 0
        for i, sl in enumerate(flat_s):
            if sl is None:
                continue
            flat = sl.reshape(Cl, -1)
            n = flat.shape[1]
            seeds = [masking.mask_stream_seed(step, shard, i, c,
                                              run_seed=cfg.seed)
                     for c in range(Cl)]
            if cfg.packed_masks:
                words = aggregation.sample_and_pack_rows(
                    flat, seeds, mode=cfg.mask_mode, tau=cfg.tau)
                ones = kref.popcount32(words).sum(dim=1).to(f32)
                parts.append(words)
                # the words of every pod's cohorts, pod-major: the rows
                # of the global participation vector
                words_all = (aggregation.all_gather_rows(words, pod)
                             if has_pod else words)
                theta = plds.mean_from_words(words_all, n, weights=wn)
                del words_all
            else:
                # the plain sampler a column piece at a time (its int64
                # hash temporaries stay a piece's size)
                masks = torch.cat([
                    kref.threshold_rows(flat[:, j:j + UPDATE_PIECE], cfg.tau)
                    if cfg.mask_mode == "threshold" else
                    kref.sample_rows(flat[:, j:j + UPDATE_PIECE], seeds, j)
                    for j in range(0, n, UPDATE_PIECE)], dim=1)
                ones = masks.sum(dim=1, dtype=f32)
                parts.append(masks)
                if part is None:
                    # the bf16 mean (jnp.mean sums bf16 in f32), then a
                    # bf16 mean over the pods
                    b = (masks.sum(dim=0, dtype=f32) / Cl).to(torch.bfloat16)
                    if has_pod:
                        dist.all_reduce(b, group=pod)
                        b = b / npod
                    theta = b.float()
                else:
                    theta = torch.tensordot(wn_l, masks.to(f32),
                                            dims=([0], [0]))
                    if has_pod:
                        dist.all_reduce(theta, group=pod)
                del masks
            ones_c = ones if ones_c is None else ones_c + ones
            u = None
            if cfg.downlink_bits:
                # the leaf's uniforms in one draw (quantize_theta's own)
                u = (next(u_it).reshape(-1) if u_it is not None else
                     torch.rand(theta.shape, generator=gen, device=dev))
            # theta crosses the downlink and every cohort restarts from
            # logit(theta), piece by piece (elementwise: the same bits,
            # with temporaries of a piece's size)
            for j in range(0, n, UPDATE_PIECE):
                t = theta[j:j + UPDATE_PIECE]
                if u is not None:
                    q = aggregation.quantize_theta(
                        [t], bits=cfg.downlink_bits,
                        u=[u[j:j + UPDATE_PIECE]])
                    t = aggregation.dequantize_theta(
                        q, bits=cfg.downlink_bits)[0]
                flat[:, j:j + UPDATE_PIECE].copy_(masking.logit(t)[None])
            del theta, u
            n_pool += n

        for f in tu.leaves(state["floats"]):
            if f is None:
                continue
            ff = f.float()
            if wn_l is not None:
                avg = torch.tensordot(wn_l, ff, dims=([0], [0]))[None]
                if has_pod:
                    dist.all_reduce(avg, group=pod)
            elif has_pod:
                # each local cohort row with its peers on the other pods
                avg = ff.clone() if ff is f else ff
                dist.all_reduce(avg, group=pod)
                avg = avg / npod
            else:
                avg = ff.mean(dim=0)[None]
            f.copy_(avg.to(f.dtype))
        for key in ("opt_m", "opt_v"):
            for m in tu.leaves(state.get(key)):
                if m is not None:
                    m.zero_()

        # eq. 13 meter from this rank's popcounts (the packed words are
        # never unpacked for it); survivors only under participation
        if n_pool:
            if part is None:
                p1 = ones_c.sum() / torch.tensor(float(n_pool * Cl),
                                                 dtype=f32, device=dev)
            else:
                p1 = (ones_c * alive).sum() / (
                    torch.tensor(float(n_pool), dtype=f32, device=dev)
                    * torch.clamp(alive.sum(), min=1.0))
            bpp = regularizer.binary_entropy(p1)
        else:
            bpp = torch.zeros((), dtype=f32, device=dev)
        # the codec meters each cohort's pooled stream of this rank's
        # blocks; the sum over every rank is the round's total
        pooled = torch.cat(parts, dim=1) if parts else None
        del parts
        per_cohort = torch.tensor(
            [0 if not n_pool else
             codec.measure_pooled_words(pooled[c], n_pool)
             if cfg.packed_masks else
             codec.measure_pooled_bits(pooled[c]) for c in range(Cl)],
            dtype=torch.int64).to(f32).to(dev)
        if alive is not None:
            per_cohort = per_cohort * alive
        bits_total = per_cohort.sum()
        if mesh is not None:
            dist.all_reduce(bits_total, group=mesh.group(mesh.axis_names))
        eff = (torch.tensor(float(C), dtype=f32, device=dev) if part is None
               else torch.clamp(part.sum(), min=1.0))
        dl_bpp = float(cfg.downlink_bits) if cfg.downlink_bits else 32.0
        metrics = {
            "bpp": bpp,
            "bpp_measured": bits_total / (torch.tensor(
                float(n_glob), dtype=f32, device=dev) * eff),
            "bits_measured": bits_total,
            "downlink_bpp": torch.tensor(dl_bpp, dtype=f32),
            "downlink_bits": torch.tensor(dl_bpp * n_glob, dtype=f32,
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


def fedavg_state_shardings(state_shapes, mesh):
    return {"params": shd.tree_param_shardings(state_shapes["params"],
                                               mesh),
            "opt_m": shd.tree_param_shardings(state_shapes["opt_m"],
                                              mesh),
            "step": shd.replicated(mesh)}


def make_fedavg_step(api, cfg: StepConfig):
    """(state, batch) -> (state, {"loss"}); batch["tokens"]: (B, S).  One
    autograd step on the float params (attention over KV chunks of
    `cfg.chunk_kv` keys if set): m = momentum * m + g in f32, then
    p = p - lr * m in p's dtype, both in place."""

    def fedavg_step(state, batch):
        params = tu.tree_map(
            lambda p: None if p is None else p.detach().requires_grad_(),
            state["params"])
        loss = api.loss(api.forward(params, batch, chunk_kv=cfg.chunk_kv),
                        batch)
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
# Serving: one decode token (the deployed artifact), and lockstep slots
# ---------------------------------------------------------------------------


def _serve_plan(api, mesh, plan):
    if (mesh is None) != (plan is None):
        raise ValueError("give both mesh and plan, or neither")
    if mesh is not None:
        partition.check_serve(api)


def make_serve_step(api, mesh=None, plan=None):
    """(params, cache, token, pos) -> (logits f32 (B, V), cache): one
    decode token through `api.decode_step`, which writes the token's
    cache entries in place.

    With a `launch.mesh.Mesh` and the rank's `partition.ServePlan` (both
    or neither; the dense, vlm and encdec families), params and cache
    are this rank's blocks under the plan's shardings and token its
    block of the batch (its client rows, or every row where the batch
    does not split over the client axes); the step runs the global
    step's semantics partitioned (`launch.partition`), writes the rank's
    cache block in place and returns the logits of the rank's rows."""
    _serve_plan(api, mesh, plan)

    def serve_step(params, cache, token, pos):
        if plan is None:
            return api.decode_step(params, cache, token, pos)
        logits, _ = api.decode_step(plan.place(params),
                                    plan.place_cache(cache), token, pos)
        return logits, cache
    return serve_step


def make_prefill_step(api, chunk_kv=None, mesh=None, plan=None):
    """(params, batch) -> logits f32 (B, V) of the batch's last position:
    the reference dry run's prefill, `api.forward(params, batch,
    chunk_kv)[0][:, -1]`, without autograd (a copy: the (B, S, V) logits
    are freed).  With a mesh and the rank's `partition.ServePlan` (both
    or neither), params are this rank's blocks and batch its client rows
    (every "model" rank the same); the logits are those of its rows."""
    _serve_plan(api, mesh, plan)

    @torch.no_grad()
    def prefill_step(params, batch):
        if plan is not None:
            params = plan.place(params)
        return api.forward(params, batch, chunk_kv=chunk_kv)[0][:, -1].clone()
    return prefill_step


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
