"""The MoE family's partitioned train step (`steps.make_train_step(api,
cfg, mesh, state_sh)` on deepseek-v2-lite-16b and deepseek-v2-236b,
`partition.ExpertLayout`) over `torch.distributed`, held rank by rank
against the JAX package's train step jitted with in_shardings
(`fed_state_shardings`: a stacked expert leaf's E on "model" and its
d_in on "data") on a forced 8-device (2, 2, 2) CPU mesh, as its dry run
jits it.  The helpers are `test_torch_mesh_train.py`'s.

One reference subprocess runs REF_RUNS: both SMOKE moe archs (E = 4, and
E = 8 with q-lora) under momentum, floats cast to f32, two steps each,
through the reference's REPRO_EFF_PATH switch (the same hash masks on
materialized weights).  One spawn of 8 gloo ranks runs the port's
counterparts on their blocks.  Each rank's blocks are held against that
device's shards: the losses within LOSS_RTOL, every score, moment and
float leaf's change within chip_smoke's BACKWARD_BOUNDS["f32"], after
both steps.  The routing is the global step's: the capacity, the queue
positions and the aux loss of the cohort's 64 tokens, where a data
rank's 32 would give another capacity.

The same ranks hold the partitioned step against the port's own
`mesh=None` step from one state, one step, at f32 (SELF_BOUNDS): both
SMOKE moe archs, deepseek-v2-lite with 3 experts (E does not split over
"model": the generic rule's column block of every expert, kernels 5-6 at
its column offset with n_logical = N) and with capacity factor 0.6 (a
capacity of 19 slots that binds, padded to 20 for the 2 data ranks).
They record one deepseek-v2-lite step's collectives, held to a closed
form from the shapes, and check that every placed leaf draws the global
leaf's block of masks.

In this process: a (1, 1, 1) mesh gives the `mesh=None` steps bit for
bit; a placed expert block of a synthetic leaf past 2**32 elements draws
the global stream's masks; the grouped product's plain version at a
column block with n_logical gives the global leaf's columns; the
capacity binds, and routing each data rank's tokens alone would be
another model.
"""
import json
import multiprocessing
import tempfile
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_mesh_train as mt
from repro_torch.core import masking, tree
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

AXES, MESH, B, S = mt.AXES, mt.MESH, mt.B, mt.S
LR, SEED = mt.LR, mt.SEED
# (name, arch, optimizers, the step after which the blocks are held,
# whether the reference runs its Pallas kernels in interpret mode)
REF_RUNS = (("dsv2lite", "deepseek-v2-lite-16b", ("momentum",), 2, False),
            ("dsv2big", "deepseek-v2-236b", ("momentum",), 2, False))
# (case, arch, config fields replaced, score dtype)
CASES = (("dsv2lite", "deepseek-v2-lite-16b", {}, "float32"),
         ("dsv2big", "deepseek-v2-236b", {}, "float32"),
         ("three_experts", "deepseek-v2-lite-16b", {"n_experts": 3},
          "float32"),
         ("padded_slots", "deepseek-v2-lite-16b", {"capacity_factor": 0.6},
          "float32"))
# masked leaves of a SMOKE moe model: the dense layer's MLA (deepseek-v2-
# lite: w_q, w_dkv, w_uk, w_uv, w_o; -236b adds w_dq, w_uq for w_q) and
# MLP 3; the MoE stack's MLA, its 3 expert leaves and the shared MLP's 3
MASKED = {"deepseek-v2-lite-16b": 19, "deepseek-v2-236b": 21}


def _cap(cfg, tokens) -> int:
    """The reference's capacity of `tokens` routed tokens."""
    return max(int(tokens * cfg.top_k * cfg.capacity_factor
                   / cfg.n_experts), 4)


def _rank_main(rank, world, store, inp, out_dir):
    import torch.distributed as dist
    from repro_torch.analysis import comm_model
    from repro_torch.launch import mesh as meshlib
    from repro_torch.runtime import elastic
    torch.set_num_threads(1)
    meshlib.init("cpu", store=dist.FileStore(store, world), rank=rank,
                 world_size=world, timeout=timedelta(seconds=120))
    try:
        mesh = meshlib.make_debug_pod_mesh()
        arrs = dict(np.load(inp))
        out, calls = {}, {}
        for run, arch, opts, held, _ in REF_RUNS:
            for opt in opts:
                tag = f"{run}/{opt}"
                api, host = mt._host_from(arrs, arch, tag, opt)
                sh = steps.fed_state_shardings(host, mesh)
                st = elastic.reshard_server(mt._clone(host), sh)
                fn = steps.make_train_step(
                    api, steps.StepConfig(lam=1.0, lr=LR, seed=SEED,
                                          optimizer=opt), mesh, sh)
                out[f"{run}/placed_masks"] = mt._placed_masks(mesh, api, host,
                                                              st, sh)
                for i in range(2):
                    pre = f"{run}/batch{i}/"
                    batch = {k[len(pre):]: torch.from_numpy(v)
                             for k, v in arrs.items() if k.startswith(pre)}
                    st, m = fn(st, mt._local_batch(batch, mesh))
                    out[f"{tag}/loss/{i}"] = m["loss"].numpy()
                    if i + 1 == held:
                        mt._blocks(tag, st, sh, host, out)
        for name, arch, over, dtype in CASES:
            api = mt._api(arch, over)
            host = mt._start(api, getattr(torch, dtype))
            sh = steps.fed_state_shardings(host, mesh)
            if name == "three_experts":
                out[f"{name}/placed_masks"] = mt._placed_masks(
                    mesh, api, host, elastic.reshard_server(
                        mt._clone(host), sh), sh)
            batch = mt._batch(api, 50)
            cfg = steps.StepConfig(lam=1.0, lr=LR, seed=SEED,
                                   score_dtype=getattr(torch, dtype))
            plain, mp = steps.make_train_step(api, cfg)(mt._clone(host),
                                                        batch)
            st = elastic.reshard_server(mt._clone(host), sh)
            with comm_model.record_collectives(mesh, check=True) as sites:
                st, mm = steps.make_train_step(api, cfg, mesh, sh)(
                    st, mt._local_batch(batch, mesh))
            calls[name] = mt._calls(sites)
            out[f"{name}/loss"] = np.array([float(mp["loss"]),
                                            float(mm["loss"])])
            mt._blocks(f"{name}/mesh", st, sh, host, out)
            for key, state in (("plain", plain), ("start", host)):
                mt._blocks(f"{name}/{key}", {k: tree.tree_map(
                    lambda x, h: None if x is None else h.local(x), v, sh[k])
                    for k, v in state.items() if k in sh and k != "step"},
                    sh, host, out)
        out["coords"] = np.array([mesh.coords[a] for a in AXES])
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
        (Path(out_dir) / f"calls{rank}.json").write_text(json.dumps(calls))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_run():
    """({rank: the port's arrays}, {rank: its recorded collectives}, the
    reference's arrays, the inputs), from one reference run and one
    spawn."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        inp = tmp / "inputs.npz"
        arrs = mt._inputs(inp, REF_RUNS)
        ref = mt._start_reference(inp, tmp / "ref.npz", REF_RUNS)
        try:
            ctx = multiprocessing.get_context("spawn")
            procs = [ctx.Process(target=_rank_main, args=(
                r, 8, str(tmp / "store"), str(inp), str(tmp)))
                for r in range(8)]
            for p in procs:
                p.start()
            mt._join(procs)
            _, err = ref.communicate(timeout=mt.RANK_TIMEOUT)
            assert ref.returncode == 0, err[-4000:]
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait(10)
        port = {r: dict(np.load(tmp / f"rank{r}.npz")) for r in range(8)}
        calls = {r: json.loads((tmp / f"calls{r}.json").read_text())
                 for r in range(8)}
        want = dict(np.load(tmp / "ref.npz"))
    return port, calls, want, arrs


@pytest.mark.parametrize("run", [r[0] for r in REF_RUNS])
def test_two_steps_equal_the_reference_shard_by_shard(mesh_run, run):
    """Every rank's blocks against its device's shards after both steps:
    the same leaves and block indices (the expert leaves' E on "model",
    d_in on "data"), both losses within LOSS_RTOL, every leaf's change
    within chip_smoke's f32 backward bounds."""
    port, _, want, arrs = mesh_run
    max_rel, min_cos = mt._chip_smoke().BACKWARD_BOUNDS["f32"]
    tag = f"{run}/momentum"
    leaves = mt._leaves(port[0], tag)
    assert leaves == sorted(k[len(tag) + 1:-len("/0/index")] for k in want
                            if k.startswith(tag + "/")
                            and k.endswith("/0/index"))
    assert {k.split("/")[0] for k in leaves} == {"scores", "floats", "opt_m"}
    # rank 0's block of an expert leaf: experts 0.. of E / 2, rows of d_in
    # / 2, every column
    E = {"dsv2lite": 4, "dsv2big": 8}[run]
    idx = port[0][f"{tag}/scores/moe_layers/moe/w_up/index"]
    assert idx.tolist() == [[0, 1], [0, 2], [0, E // 2], [0, 32], [0, 32]]
    for r in range(8):
        for i in range(2):
            np.testing.assert_allclose(port[r][f"{tag}/loss/{i}"],
                                       want[f"{tag}/loss/{i}"],
                                       rtol=mt.LOSS_RTOL)
        for leaf in leaves:
            idx = port[r][f"{tag}/{leaf}/index"]
            assert np.array_equal(idx, want[f"{tag}/{leaf}/{r}/index"]), (
                leaf, r)
            key, path = leaf.split("/", 1)
            start = arrs.get(f"{tag}/{key}/{path}")
            start = (np.zeros_like(want[f"{tag}/{leaf}/{r}"]) if start is None
                     else start[tuple(slice(a, b) for a, b in idx)])
            rel, cos = mt._agree(want[f"{tag}/{leaf}/{r}"] - start,
                                 port[r][f"{tag}/{leaf}"] - start)
            assert rel <= max_rel and cos >= min_cos, (tag, leaf, r, rel,
                                                       cos)


def test_placed_leaves_draw_the_global_masks(mesh_run):
    """On every rank, each placed masked leaf of both moe archs and of the
    3-expert fallback (the expert leaves' blocks at the global leaf's
    per-(layer, expert) offsets moved by the block's rows and columns)
    materializes to the global leaf's block of effective weights bit for
    bit."""
    port, _, _, _ = mesh_run
    for r in range(8):
        for run, arch in (("dsv2lite", "deepseek-v2-lite-16b"),
                          ("dsv2big", "deepseek-v2-236b"),
                          ("three_experts", "deepseek-v2-lite-16b")):
            got = port[r][f"{run}/placed_masks"]
            assert len(got) == MASKED[arch] and got[:, 1].all(), (r, run,
                                                                  got)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_partitioned_step_equals_the_plain_step(mesh_run, case):
    """The partitioned step against `mesh=None` from one state, one step,
    block by block on every rank: the global mean loss within LOSS_RTOL,
    every leaf's update within SELF_BOUNDS."""
    port, _, _, _ = mesh_run
    for r in range(8):
        got = port[r]
        loss = got[f"{case}/loss"]
        np.testing.assert_allclose(loss[1], loss[0], rtol=mt.LOSS_RTOL)
        leaves = mt._leaves(got, f"{case}/mesh")
        assert leaves == mt._leaves(got, f"{case}/plain")
        for leaf in leaves:
            start = got[f"{case}/start/{leaf}"]
            rel, cos = mt._agree(got[f"{case}/plain/{leaf}"] - start,
                                 got[f"{case}/mesh/{leaf}"] - start)
            assert rel <= mt.SELF_BOUNDS[0] and cos >= mt.SELF_BOUNDS[1], (
                case, leaf, r, rel, cos)


def test_fallback_and_padded_cases_are_what_they_claim(mesh_run):
    """3 experts do not split over "model": the expert leaves keep E whole
    and split d_ff (w_up's columns, w_down's rows over "data" and columns
    over "model"); capacity factor 0.6 gives 19 slots a cohort, padded to
    20 for the reduce-scatter over the 2 data ranks."""
    port, _, _, _ = mesh_run
    idx = port[0]["three_experts/mesh/scores/moe_layers/moe/w_up/index"]
    assert idx.tolist() == [[0, 1], [0, 2], [0, 3], [0, 32], [0, 16]]
    idx = port[0]["three_experts/mesh/scores/moe_layers/moe/w_down/index"]
    assert idx.tolist() == [[0, 1], [0, 2], [0, 3], [0, 16], [0, 32]]
    cfg = mt._api("deepseek-v2-lite-16b", {"capacity_factor": 0.6}).cfg
    assert _cap(cfg, B * S) == 19 and _cap(cfg, B * S) % MESH[1]


def test_routing_is_global_over_the_cohort():
    """The cohort's capacity is not a data rank's (64 tokens: 40 slots;
    32: 20), and at capacity factor 0.6 it binds: routing each data rank's
    rows alone (its own capacity and queues) gives another loss than the
    global routing (measured 6e-4 of it), far beyond LOSS_RTOL, so the
    partitioned step's agreement with `mesh=None` and the reference holds
    the global routing."""
    cfg = mt._api("deepseek-v2-lite-16b").cfg
    assert (_cap(cfg, B * S), _cap(cfg, B * S // MESH[1])) == (40, 20)
    api = mt._api("deepseek-v2-lite-16b", {"capacity_factor": 0.6})
    st = mt._start(api)
    tokens = mt._batch(api, 50)["tokens"][0]
    mp = masking.MaskedParams(
        st["weights"], tree.tree_map(lambda s: None if s is None else s[0],
                                     st["scores"]),
        tree.tree_map(lambda f: None if f is None else f[0], st["floats"]))
    params = masking.masked_forward_tree(
        mp, lambda i: masking.mask_stream_seed(0, 0, i, 0, run_seed=SEED))
    with torch.no_grad():
        whole = float(api.loss(api.forward(params, {"tokens": tokens}),
                               {"tokens": tokens}))
        halves = [float(api.loss(api.forward(params, {"tokens": t}),
                                 {"tokens": t}))
                  for t in tokens.chunk(MESH[1])]
    assert abs(sum(halves) / len(halves) - whole) > 10 * mt.LOSS_RTOL * whole


def _wire(api, host, sh, mesh_shape, tokens, act_bytes):
    """{(prim, dtype, axes): elements} one partitioned step of one cohort
    a rank sends: the dense leaves and floats as
    `test_torch_mesh_train._wire` counts them; a MoE layer the router
    logits gathered over "data" (their gradient reduce-scattered), the
    dispatched slots reduce-scattered over "data" (their gradient
    gathered), the dispatch's dx all-reduced over "model", each expert
    leaf's w (bf16) and s rows gathered over "data" and its ds
    reduce-scattered there, the experts' outputs gathered over "data"
    (their gradient reduce-scattered) and over "model"."""
    dd, dm = mesh_shape["data"], mesh_shape["model"]
    act = "float32" if act_bytes == 4 else "bfloat16"
    dense = dict(host, scores=tree.tree_map(
        lambda s: None if s is None or s.ndim == 5 else s, host["scores"]))
    out = mt._wire(api, dense, sh, mesh_shape, tokens, act_bytes)

    def add(prim, dtype, axes, n):
        key = (prim, dtype, axes)
        out[key] = out.get(key, 0) + n
    cfg = api.cfg
    E, D = cfg.n_experts, cfg.d_model
    El, cap = E // dm, _cap(cfg, tokens * dd)
    slots = -(-cap // dd) * dd
    layers_ = cfg.n_layers - cfg.first_dense_layers
    for _ in range(layers_):
        add("all_gather", "float32", ("data",), tokens * E)
        add("reduce_scatter", "float32", ("data",), tokens * dd * E)
        add("psum", act, ("model",), tokens * D)
        add("reduce_scatter", "float32", ("data",), El * slots * D)
        add("all_gather", "float32", ("data",), El * slots // dd * D)
        add("all_gather", "float32", ("data",), El * slots // dd * D)
        add("reduce_scatter", "float32", ("data",), El * slots * D)
        add("all_gather", "float32", ("model",), El * slots * D)
    for s in tree.leaves(host["scores"]):
        if s is not None and s.ndim == 5:
            K, N = s.shape[-2:]
            for _ in range(s.shape[1]):
                add("all_gather", "bfloat16", ("data",), El * K // dd * N)
                add("all_gather", "float32", ("data",), El * K // dd * N)
                add("reduce_scatter", "float32", ("data",), El * K * N)
    return out


def test_recorded_wire_equals_the_closed_form(mesh_run):
    """deepseek-v2-lite's SMOKE step on every rank: the collectives it
    recorded, summed by kind, dtype and axes, equal `_wire` from the
    shapes."""
    _, calls, _, _ = mesh_run
    api = mt._api("deepseek-v2-lite-16b")
    host = mt._start(api)

    class Stub:
        shape, axis_names = dict(zip(AXES, MESH)), AXES
        coords = dict.fromkeys(AXES, 0)
    sh = steps.fed_state_shardings(host, Stub())
    want = _wire(api, host, sh, Stub.shape, B // MESH[1] * S, 4)
    assert want[("all_gather", "float32", ("model",))] > 0
    for r in range(8):
        got = {}
        for prim, dtype, axes, n in calls[r]["dsv2lite"]:
            key = (prim, dtype, tuple(axes))
            got[key] = got.get(key, 0) + n
        assert got == want, r


def test_world_of_one_equals_the_plain_step(tmp_path):
    """On a (1, 1, 1) mesh the partitioned step of both moe archs is the
    `mesh=None` step bit for bit, two steps under momentum and adam
    (scores, moments, floats, losses); one thread, so every CPU reduction
    sums in one order."""
    import torch.distributed as dist
    from repro_torch.runtime import elastic
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mesh = mt._world_of_one(tmp_path)
    try:
        for arch, opt in (("deepseek-v2-lite-16b", "momentum"),
                          ("deepseek-v2-lite-16b", "adam"),
                          ("deepseek-v2-236b", "momentum")):
            api = mt._api(arch)
            host = mt._start(api, optimizer=opt)
            cfg = steps.StepConfig(lam=1.0, lr=LR, seed=SEED, optimizer=opt)
            sh = steps.fed_state_shardings(host, mesh)
            a = mt._clone(host)
            b = elastic.reshard_server(mt._clone(host), sh)
            fa = steps.make_train_step(api, cfg)
            fb = steps.make_train_step(api, cfg, mesh, sh)
            for i in range(2):
                batch = mt._batch(api, 60 + i)
                a, ma = fa(a, batch)
                b, mb = fb(b, batch)
                assert torch.equal(ma["loss"], mb["loss"]), (arch, opt, i)
            for key in ("scores", "floats", "opt_m", "opt_v"):
                for x, y in zip(tree.leaves(a.get(key)),
                                tree.leaves(b.get(key))):
                    assert (x is None and y is None) or torch.equal(x, y), (
                        arch, opt, key)
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


def test_placed_expert_block_past_the_wrap_draws_the_global_masks():
    """A synthetic stacked expert leaf of 5 x 64 x 4096 x 4096 scores (5 *
    2**30 elements: layer 4's offsets wrap past 2**32) on a (1, 64, 64)
    mesh: the last rank's placed block (expert 63, rows 4032.., every
    column), drawn by `materialize_leaf`, equals the global stream's
    masks computed element by element from the flat index (l*E + e)*K*N +
    row*N + col mod 2**32."""
    from repro_torch.launch import partition
    L, E, K, N, dd, dm = 5, 64, 4096, 4096, 64, 64
    G = (1, L, E, K, N)

    class Stub:
        shape, axis_names = {"pod": 1, "data": dd, "model": dm}, AXES
        coords = {"pod": 0, "data": dd - 1, "model": dm - 1}

        def group(self, axes):
            return None
    mesh = Stub()
    spec = shd.explain_spec("moe_layers/moe/w_up", G, mesh, scan_dims=2)
    assert spec.rule == "moe-expert"
    local = (1, L, E // dm, K // dd, N)
    gen = torch.Generator().manual_seed(3)
    s = 2.0 * torch.randn(local, generator=gen)
    w = torch.randn(local[1:], generator=gen).to(torch.bfloat16)
    state = {"scores": {"w_up": s}, "floats": {}}
    state_sh = {"scores": {"w_up": shd.NamedSharding(mesh, shd.P(
                    "pod", *tuple(spec.spec)[1:]))},
                "weights": {"w_up": shd.NamedSharding(mesh, shd.P(
                    *tuple(spec.spec)[1:]))},
                "floats": {}}
    plan = partition.TrainPlan(mesh, state, state_sh)
    assert isinstance(plan.layouts[0][0], partition.ExpertLayout)
    seed = masking.mask_stream_seed(2, 0, 0, 0, run_seed=SEED)
    got = masking.materialize_leaf(plan.place(0, masking.MaskedLeaf.build(
        w, s[0], seed))).detach()
    e0, r0 = (dm - 1) * (E // dm), (dd - 1) * (K // dd)
    flat = ((np.arange(L)[:, None, None, None] * E + e0
             + np.arange(E // dm)[None, :, None, None]) * (K * N)
            + (r0 + np.arange(K // dd))[None, None, :, None] * N
            + np.arange(N)[None, None, None, :])
    assert flat.max() >= 2 ** 32 > flat[:-1].max()
    u = kref.hash_uniform(torch.from_numpy(flat % 2 ** 32),
                          torch.tensor(seed, dtype=torch.int64))
    m = (u < torch.sigmoid(s[0])).to(torch.bfloat16)
    assert torch.equal(got, m * w)


def test_grouped_column_block_draws_the_global_columns():
    """`ops.masked_dense_grouped` (its plain version on the CPU) on a
    column block c0:c1 of stacked (E, K, N) experts, its offsets moved by
    c0 and n_logical = N: on one-hot rows its product is the global
    leaf's columns bit for bit, and so is the gradient of the scores
    (kernel 7's plain version on the block)."""
    gen = torch.Generator().manual_seed(7)
    E, K, N, c0, c1 = 3, 24, 40, 8, 28
    w = torch.randn(E, K, N, generator=gen).to(torch.bfloat16)
    s = 2.0 * torch.randn(E, K, N, generator=gen)
    seeds = np.full(E, masking.mask_stream_seed(1, 0, 4, 0, run_seed=SEED),
                    np.uint32)
    offs = masking.stream_offsets((E,), K, N) + np.uint32(K * N * 7)
    x = torch.eye(K).expand(E, K, K).contiguous()
    g = torch.randn(E, K, N, generator=gen)
    sf = s.clone().requires_grad_()
    y = ops.masked_dense_grouped(x, w, sf, seeds, offs)
    (y * g).sum().backward()
    sb = s[..., c0:c1].clone().requires_grad_()
    yb = ops.masked_dense_grouped(x, w[..., c0:c1].contiguous(), sb, seeds,
                                  offs + np.uint32(c0), n_logical=N)
    (yb * g[..., c0:c1]).sum().backward()
    assert torch.equal(yb, y[..., c0:c1])
    assert torch.equal(sb.grad, sf.grad[..., c0:c1])
    # without n_logical the block would draw another stream
    other = ops.masked_dense_grouped(x, w[..., c0:c1].contiguous(),
                                     s[..., c0:c1], seeds,
                                     offs + np.uint32(c0))
    assert not torch.equal(other, y[..., c0:c1])

