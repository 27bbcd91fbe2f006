"""The partitioned train step over token groups that cut across data ranks
(`steps.make_train_step(api, cfg, mesh, state_sh)` with
`StepConfig.microbatch` = M > 1, and `moe_block_dispatch` = G > 0 for
the moe family), held rank by rank against the JAX package's train step
jitted with in_shardings on forced 8-device CPU meshes, as its dry run
jits it.  The helpers are `test_torch_mesh_train.py`'s.

One reference subprocess runs REF_RUNS through its REPRO_EFF_PATH
switch (the same hash masks on materialized weights), SMOKE models with
their floats cast to f32, two steps each, a cohort's batch of 4 rows of
16 tokens: internlm2 at M = 2 on (2, 2, 2) (a chunk of 2 rows is one
data rank's rows) and at M = 4 (two chunks a rank), deepseek-v2-lite on
(1, 4, 2) at M = 2 (a chunk and its routing group over a 2-rank data
subgroup), at G = 2 (a block of 32 tokens over 2 ranks) and at G = 8
(2 blocks of 8 tokens a rank), and mamba2 at M = 2 on (2, 2, 2).  One
spawn of 8 gloo ranks runs the port's counterparts on their blocks,
held shard by shard after both steps: the losses within LOSS_RTOL,
every score, moment and float leaf's change within chip_smoke's
BACKWARD_BOUNDS["f32"].

The same ranks hold the partitioned step against the port's own
`mesh=None` step from one state, one step (SELF_BOUNDS, bf16 as
`test_torch_mesh_train.py` holds it): a 6-row batch on 2 data ranks at
M = 3 (pieces of one row, a chunk across two ranks), G = 16 on 64 tokens
(blocks of 4 < 8 tokens: the whole cohort is one group) and bf16 scores
at M = 2; they refuse deepseek-v2-lite's 6 rows at M = 3 (routing
groups of 32 tokens on ranks of 48), and record the first step's
collectives of every run: internlm2 at M = 4 held to chip_smoke's
`block_sites`, the moe runs' expert layouts to `moe_expert_sites`.

In this process: a (1, 1, 1) mesh gives the `mesh=None` steps bit for
bit at M = 2 and 4, G = 4, bf16 scores and mamba2; the pieces'
arithmetic.
"""
import json
import math
import multiprocessing
import tempfile
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_mesh_train as mt
from repro_torch.core import tree
from repro_torch.launch import partition, steps
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

AXES, B, S = mt.AXES, mt.B, mt.S
LR, SEED = mt.LR, mt.SEED
POD, WIDE = (2, 2, 2), (1, 4, 2)
# (name, arch, optimizers, the step after which the blocks are held,
# whether the reference runs its Pallas kernels in interpret mode, its
# mesh, microbatch and config fields replaced)
REF_RUNS = (
    ("m2", "internlm2-1.8b", ("momentum",), 2, False,
     {"mesh": POD, "microbatch": 2}),
    ("m4", "internlm2-1.8b", ("momentum",), 2, False,
     {"mesh": POD, "microbatch": 4}),
    ("moe_m2", "deepseek-v2-lite-16b", ("momentum",), 2, False,
     {"mesh": WIDE, "microbatch": 2}),
    ("moe_g2", "deepseek-v2-lite-16b", ("momentum",), 2, False,
     {"mesh": WIDE, "patch": {"moe_block_dispatch": 2}}),
    ("moe_g8", "deepseek-v2-lite-16b", ("momentum",), 2, False,
     {"mesh": WIDE, "patch": {"moe_block_dispatch": 8}}),
    ("mamba_m2", "mamba2-370m", ("momentum",), 2, False,
     {"mesh": POD, "microbatch": 2}))
# (case, arch, config fields replaced, score dtype, mesh, microbatch,
# a cohort's rows)
CASES = (("unaligned", "internlm2-1.8b", {}, "float32", POD, 3, 6),
         ("fallback_g16", "deepseek-v2-lite-16b", {"moe_block_dispatch": 16},
          "float32", WIDE, 1, 4),
         ("bf16_m2", "internlm2-1.8b", {}, "bfloat16", POD, 2, 4))
# deepseek-v2-lite at 6 rows and M = 3 on 2 data ranks: routing groups of
# 2 rows (32 tokens) on ranks of 3 (48)
REFUSED = ("deepseek-v2-lite-16b", POD, 3, 6)


def _rows_batch(api, seed, rows):
    """A global (C, rows, S) token batch."""
    gen = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, api.cfg.vocab, (mt.C, rows, S),
                                    generator=gen)}


def _rank_main(rank, world, store, inp, out_dir):
    import torch.distributed as dist
    from repro_torch.analysis import comm_model
    from repro_torch.launch import mesh as meshlib
    from repro_torch.runtime import elastic
    torch.set_num_threads(1)
    meshlib.init("cpu", store=dist.FileStore(store, world), rank=rank,
                 world_size=world, timeout=timedelta(seconds=120))
    try:
        meshes = {POD: meshlib.make_debug_pod_mesh(),
                  WIDE: meshlib.Mesh(WIDE, AXES)}
        sub = meshes[WIDE].data_group(2)
        out, calls = {}, {}
        out["subgroup"] = np.array(dist.get_process_group_ranks(sub))
        out["subgroup_axes"] = np.array(meshes[WIDE].group_axes(sub))
        arrs = dict(np.load(inp))
        for run, arch, opts, held, _, over in REF_RUNS:
            mesh = meshes[over["mesh"]]
            api = mt._api(arch, over.get("patch"))
            for opt in opts:
                tag = f"{run}/{opt}"
                _, host = mt._host_from(arrs, arch, tag, opt)
                sh = steps.fed_state_shardings(host, mesh)
                st = elastic.reshard_server(mt._clone(host), sh)
                fn = steps.make_train_step(
                    api, steps.StepConfig(
                        lam=1.0, lr=LR, seed=SEED, optimizer=opt,
                        microbatch=over.get("microbatch", 1)), mesh, sh)
                for i in range(2):
                    pre = f"{run}/batch{i}/"
                    batch = {k[len(pre):]: torch.from_numpy(v)
                             for k, v in arrs.items() if k.startswith(pre)}
                    with comm_model.record_collectives(
                            mesh, check=True) as sites:
                        st, m = fn(st, mt._local_batch(batch, mesh))
                    if i == 0:
                        calls[run] = mt._calls(sites)
                    out[f"{tag}/loss/{i}"] = m["loss"].numpy()
                    if i + 1 == held:
                        mt._blocks(tag, st, sh, host, out)
        for name, arch, over, dtype, shape, M, rows in CASES:
            mesh = meshes[shape]
            api = mt._api(arch, over)
            host = mt._start(api, getattr(torch, dtype))
            sh = steps.fed_state_shardings(host, mesh)
            batch = _rows_batch(api, 50, rows)
            cfg = steps.StepConfig(lam=1.0, lr=LR, seed=SEED, microbatch=M,
                                   score_dtype=getattr(torch, dtype))
            plain, mp = steps.make_train_step(api, cfg)(mt._clone(host),
                                                        batch)
            st = elastic.reshard_server(mt._clone(host), sh)
            st, mm = steps.make_train_step(api, cfg, mesh, sh)(
                st, mt._local_batch(batch, mesh))
            out[f"{name}/loss"] = np.array([float(mp["loss"]),
                                            float(mm["loss"])])
            mt._blocks(f"{name}/mesh", st, sh, host, out)
            for key, state in (("plain", plain), ("start", host)):
                mt._blocks(f"{name}/{key}", {k: tree.tree_map(
                    lambda x, h: None if x is None else h.local(x), v, sh[k])
                    for k, v in state.items() if k in sh and k != "step"},
                    sh, host, out)
        arch, shape, M, rows = REFUSED
        mesh, api = meshes[shape], mt._api(arch)
        host = mt._start(api)
        sh = steps.fed_state_shardings(host, mesh)
        fn = steps.make_train_step(api, steps.StepConfig(microbatch=M),
                                   mesh, sh)
        try:
            fn(elastic.reshard_server(host, sh),
               mt._local_batch(_rows_batch(api, 51, rows), mesh))
            calls["refused"] = ""
        except NotImplementedError as e:
            calls["refused"] = str(e)
        out["coords"] = np.array([meshes[POD].coords[a] for a in AXES])
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
    the same leaves and block indices, both losses within LOSS_RTOL,
    every leaf's change within chip_smoke's f32 backward bounds."""
    port, _, want, arrs = mesh_run
    max_rel, min_cos = mt._chip_smoke().BACKWARD_BOUNDS["f32"]
    tag = f"{run}/momentum"
    leaves = mt._leaves(port[0], tag)
    assert leaves == sorted(k[len(tag) + 1:-len("/0/index")] for k in want
                            if k.startswith(tag + "/")
                            and k.endswith("/0/index"))
    assert {k.split("/")[0] for k in leaves} == {"scores", "floats", "opt_m"}
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


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_partitioned_step_equals_the_plain_step(mesh_run, case):
    """The partitioned step against `mesh=None` from one state, one step,
    block by block on every rank: the global mean loss within LOSS_RTOL,
    every f32 leaf's update within SELF_BOUNDS; bf16 scores within one
    bf16 ulp of mesh=None's and their moments within
    BF16_MOMENT_BOUNDS."""
    port, _, _, _ = mesh_run
    dtype = dict((c[0], c[3]) for c in CASES)[case]
    for r in range(8):
        got = port[r]
        loss = got[f"{case}/loss"]
        np.testing.assert_allclose(loss[1], loss[0], rtol=mt.LOSS_RTOL)
        leaves = mt._leaves(got, f"{case}/mesh")
        assert leaves == mt._leaves(got, f"{case}/plain")
        for leaf in leaves:
            want, have = got[f"{case}/plain/{leaf}"], got[f"{case}/mesh/{leaf}"]
            bf16 = dtype == "bfloat16" and not leaf.startswith("floats")
            if bf16 and leaf.startswith("scores"):
                assert mt._bf16_ulps(want, have) <= 1, (case, leaf, r)
                continue
            start = got[f"{case}/start/{leaf}"]
            rel, cos = mt._agree(want - start, have - start)
            bound = mt.BF16_MOMENT_BOUNDS if bf16 else mt.SELF_BOUNDS
            assert rel <= bound[0] and cos >= bound[1], (case, leaf, r, rel,
                                                         cos)


def test_unaligned_moe_groups_are_refused(mesh_run):
    """Every rank refuses deepseek-v2-lite's 6 rows at M = 3 on 2 data
    ranks on the first call, before any collective, naming the groups'
    and the ranks' token counts."""
    _, calls, _, _ = mesh_run
    for r in range(8):
        msg = calls[r]["refused"]
        assert "routing groups of 32 tokens" in msg, (r, msg)
        assert "a data rank's 48 tokens" in msg, (r, msg)


def test_data_subgroups(mesh_run):
    """On (1, 4, 2) the 2-rank data subgroup of rank r holds the ranks of
    its model column at data coordinates 2 * (data // 2) and one more,
    keyed "data/2"."""
    port, _, _, _ = mesh_run
    for r in range(8):
        data, model = divmod(r, 2)
        first = 2 * (data // 2)
        assert port[r]["subgroup"].tolist() == [
            2 * first + model, 2 * (first + 1) + model], r
        assert port[r]["subgroup_axes"].tolist() == ["data/2"], r


def _operands(sites):
    from repro_torch.launch import dryrun
    got = {}
    for prim, dtype, axes, n in sites:
        key = f"{dryrun.HLO_KINDS[prim]} {'x'.join(axes)} {dtype}"
        got.setdefault(key, {})
        got[key][str(n)] = got[key].get(str(n), 0) + 1
    return got


def test_recorded_wire_equals_block_sites(mesh_run):
    """internlm2 at M = 4 (two pieces of one row a rank): the first step's
    collectives, by kind, axes, type and operand size, equal chip_smoke's
    `block_sites` at pieces = 2: every w and s gather and ds reduce once a
    layer and piece, the activations' "model" collectives on a piece's
    16 tokens, the float leaves gathered once and their gradients reduced
    once a piece."""
    _, calls, _, _ = mesh_run
    cs = mt._chip_smoke()
    host = mt._start(mt._api("internlm2-1.8b"))
    shape = dict(zip(AXES, POD))
    sh = steps.fed_state_shardings(host, cs.stub_mesh(shape))
    want, _ = cs.block_sites(host, sh, shape, B // POD[1] * S, 1,
                             act="float32", pieces=2)
    one, _ = cs.block_sites(host, sh, shape, B // POD[1] * S, 1,
                            act="float32")
    # the dx all-reduces over "model": a piece's half of the tokens, twice
    # the calls
    key = "all-reduce model float32"
    assert want[key] == {str(int(e) // 2): 2 * c
                         for e, c in one[key].items()}
    for r in range(8):
        assert _operands(calls[r]["m4"]) == want, r


@pytest.mark.parametrize("run, micro, blocks, span", [
    ("moe_m2", 2, 0, 2), ("moe_g2", 1, 2, 2), ("moe_g8", 1, 8, 1)])
def test_moe_wire_equals_the_closed_form(mesh_run, run, micro, blocks,
                                         span):
    """The moe runs' first step on every rank: every collective, by kind,
    axes, type and operand size, as chip_smoke's `moe_step_sites` gives
    it: a routing group over 2 data ranks routed over their subgroup
    "data/2" (M = 2: a chunk; G = 2: a block), 2 groups a rank routed
    there with no routing collective (G = 8)."""
    _, calls, _, _ = mesh_run
    cs = mt._chip_smoke()
    api = mt._api("deepseek-v2-lite-16b")
    host = mt._start(api)
    shape = dict(zip(AXES, WIDE))
    sh = steps.fed_state_shardings(host, cs.stub_mesh(shape))
    want, rt = cs.moe_step_sites(api.cfg, host, sh, shape, B // WIDE[1] * S,
                                 2, "float32", micro, blocks)
    assert rt["span"] == span and rt["groups"] == (2 if span == 1 else 1)
    routed = {k for k in want if k.split()[1].startswith("data/")}
    assert routed == ({"all-gather data/2 float32",
                       "reduce-scatter data/2 float32"} if span > 1
                      else set())
    for r in range(8):
        assert _operands(calls[r][run]) == want, r


def test_world_of_one_equals_the_plain_step(tmp_path):
    """On a (1, 1, 1) mesh the microbatched partitioned step is the
    `mesh=None` step bit for bit, two steps each (scores, moments,
    floats, losses): internlm2 at M = 2 under momentum and at M = 4 on
    bf16 scores under adam, deepseek-v2-lite at M = 2 with G = 4, and
    mamba2 at M = 2; one thread, so every CPU reduction sums in one
    order."""
    import torch.distributed as dist
    from repro_torch.runtime import elastic
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mesh = mt._world_of_one(tmp_path)
    try:
        for arch, over, M, opt, dtype in (
                ("internlm2-1.8b", {}, 2, "momentum", torch.float32),
                ("internlm2-1.8b", {}, 4, "adam", torch.bfloat16),
                ("deepseek-v2-lite-16b", {"moe_block_dispatch": 4}, 2,
                 "momentum", torch.float32),
                ("mamba2-370m", {}, 2, "momentum", torch.float32)):
            api = mt._api(arch, over)
            host = mt._start(api, dtype, optimizer=opt)
            cfg = steps.StepConfig(lam=1.0, lr=LR, seed=SEED, optimizer=opt,
                                   microbatch=M, score_dtype=dtype)
            sh = steps.fed_state_shardings(host, mesh)
            a = mt._clone(host)
            b = elastic.reshard_server(mt._clone(host), sh)
            fa = steps.make_train_step(api, cfg)
            fb = steps.make_train_step(api, cfg, mesh, sh)
            for i in range(2):
                batch = mt._batch(api, 60 + i)
                a, ma = fa(a, batch)
                b, mb = fb(b, batch)
                assert torch.equal(ma["loss"], mb["loss"]), (arch, M, i)
            for key in ("scores", "floats", "opt_m", "opt_v"):
                for x, y in zip(tree.leaves(a.get(key)),
                                tree.leaves(b.get(key))):
                    assert (x is None and y is None) or torch.equal(x, y), (
                        arch, M, key)
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


@pytest.mark.parametrize("rows, M, d", [
    (4, 2, 1), (2, 2, 2), (2, 4, 2), (3, 3, 2), (8, 2, 16), (8, 32, 16),
    (6, 4, 4), (5, 2, 2)])
def test_pieces_cover_the_chunks(rows, M, d):
    """`partition.batch_pieces` on every data rank: the same count of
    pieces, each inside one rank and one global chunk (its rows' chunk
    and its first's agree), the pieces in rank order tiling the global
    batch, every chunk covered; data 1 gives the chunks themselves."""
    B = rows * d
    c = B // M
    pieces = [partition.batch_pieces(rows, M, d, r) for r in range(d)]
    g = pieces[0][0]
    assert all(p[0] == g and len(p[1]) == rows // g for p in pieces)
    assert g == math.gcd(c, rows) and rows % g == 0
    flat = [j for _, chunks in pieces for j in chunks]
    for i, j in enumerate(flat):
        assert (i * g) // c == j == (i * g + g - 1) // c
    assert sorted(set(flat)) == list(range(M))
    if d == 1:
        assert pieces[0] == (c, list(range(M)))


def test_uneven_batch_raises():
    """A batch that does not split into M chunks raises ValueError, on a
    mesh and off it."""
    with pytest.raises(ValueError, match="does not split"):
        partition.batch_pieces(3, 2, 1, 0)
    with pytest.raises(ValueError, match="does not split"):
        partition.batch_pieces(3, 4, 2, 1)


def test_dry_run_cells_run_patched_partitioned_steps():
    """`dryrun.cell` with the fields `--patch` gives, on rank 0 of a
    stand-in (1, 4, 2) mesh (SMOKE deepseek-v2-lite, train_4k: 64 rows of
    4096 tokens a data rank): at M = 2 the partitioned step on meta
    tensors routes each chunk of 128 rows over its 2-rank data subgroup,
    at G = 64 each rank routes 16 blocks of 4 rows alone; every
    collective as `moe_step_sites` gives it, kernels 5-6
    exactly the global step's flops over the device count times the
    expert rows' ratio; the cells' keys."""
    import torch.distributed as dist
    from repro_torch.analysis import stream_cover
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib
    cs = mt._chip_smoke()
    cfg = mt._api("deepseek-v2-lite-16b").cfg
    meshlib.init_dry(8)
    try:
        mesh = meshlib.Mesh(WIDE, AXES, device=torch.device("cpu"))
        for patch, span in (({"microbatch": 2}, 2),
                            ({"moe_block_dispatch": 64}, 1)):
            r = dryrun.cell("deepseek-v2-lite-16b", "train_4k", True,
                            step_kind="train", cfg_patch=patch,
                            device="cpu", smoke=True, mesh=mesh)
            assert set(r) == {"stream_cover", "train_step"}
            t = r["train_step"]
            _, meta = stream_cover.meta_fed_state(cfg, 1)
            want, rt = cs.moe_step_sites(
                cfg, meta, steps.fed_state_shardings(
                    meta, cs.stub_mesh(dict(zip(AXES, WIDE)))),
                dict(zip(AXES, WIDE)), 64 * 4096, 1, "bfloat16",
                patch.get("microbatch", 1),
                patch.get("moe_block_dispatch", 0))
            assert rt["span"] == span
            assert t["collective_operands"] == want
            subs = {k.split()[1] for k in t["collective_operands"]}
            assert ("data/2" in subs) == (span == 2), subs
            mine_rows = (rt["pieces"] * cfg.n_experts // WIDE[2]
                         * rt["slots"] // span)
            glob_rows = (patch.get("microbatch", 1) * rt["blocks"]
                         * rt["cap"] * cfg.n_experts)
            for k in ("masked_matmul_grouped", "masked_matmul_grouped_dx"):
                glob = int(t["global_step"]["kernel_work"][k]["flops"])
                assert glob * mine_rows == int(
                    t["kernel_work"][k]["flops"]) * glob_rows, k
    finally:
        dist.destroy_process_group()
    assert dryrun.cell_key("a", "s", "m", {"microbatch": 2, "chunk_kv": 8}) \
        == "a|s|m|chunk_kv=8,microbatch=2"
    assert dryrun.cell_key("a", "s", "m") == "a|s|m"
