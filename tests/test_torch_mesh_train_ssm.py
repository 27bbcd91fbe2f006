"""The ssm and hybrid families' partitioned train step
(`steps.make_train_step(api, cfg, mesh, state_sh)` on mamba2-370m and
recurrentgemma-9b, `partition.BlockLayout.conv` for their depthwise conv
leaves) over `torch.distributed`, held rank by rank against the JAX
package's train step jitted with in_shardings (`fed_state_shardings`:
a conv leaf's C on "model" and its W taps on "data" where d_data divides
W, the generic rule) on a forced 8-device (2, 2, 2) CPU mesh, as its dry
run jits it.  The helpers are `test_torch_mesh_train.py`'s.

One reference subprocess runs REF_RUNS: both SMOKE archs under momentum,
floats cast to f32, two steps each, through the reference's
REPRO_EFF_PATH switch (the same hash masks on materialized weights).
One spawn of 8 gloo ranks runs the port's counterparts on their blocks.
Each rank's blocks are held against that device's shards: the losses
within LOSS_RTOL, mamba2's every score, moment and float leaf's change
within chip_smoke's BACKWARD_BOUNDS["f32"] after both steps,
recurrentgemma's within HYBRID_BOUNDS after its first (REF_RUNS says
why), beside the port's own `mesh=None` step on the same inputs.

The same ranks hold the partitioned step against the port's own
`mesh=None` step from one state, one step (SELF_BOUNDS): both SMOKE
archs, mamba2 with conv_width = 3 (the taps do not split over "data",
the production meshes' layout: ds all-reduced there), recurrentgemma
with lru_width = 65 (its conv's channels, and its gates' columns, do not
split over "model": each is computed whole on every model rank), and
mamba2 on bf16 scores.  They record one mamba2 step's collectives, held
to a closed form from the shapes, and check that every placed leaf
draws the global leaf's block of masks.

In this process: a (1, 1, 1) mesh gives the `mesh=None` steps bit for
bit, the torchrun entry's `--arch mamba2-370m` steps too; kernel 8's
and 9's plain versions on a channel block, at the leaf's offset moved by
c0 with n_logical = C, give the global conv's channels; the hybrid's
plan places every masked leaf as a 2-D body, none as an expert leaf.
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
from repro_torch.launch import steps
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

AXES, MESH, B, S = mt.AXES, mt.MESH, mt.B, mt.S
LR, SEED = mt.LR, mt.SEED
# (name, arch, optimizers, the step after which the blocks are held,
# whether the reference runs its Pallas kernels in interpret mode).
# recurrentgemma's blocks are held after its first step, its losses after
# both: at the SMOKE init (the fan-in quirk puts |u| up to 74) about 45%
# of its RG-LRU gates r underflow to 0 and a band of them leaves 1 - a^2
# a few f32 ulps above 0, where the derivative of sqrt(1 - a^2) is ~1/
# sqrt(6e-8) and quantized, so a 1-ulp difference of exp or sigmoid
# between XLA and torch moves the gates' gradient by percents.  The
# port's own `mesh=None` step differs from the reference's by up to
# 0.054 in relative norm per block after the first step (cosine 0.99915),
# exactly as its partitioned step does, and by 0.066 after the second
# (whole leaves; 0.020 after the first), where the reference's own jit
# and eager f32 steps differ by 6.3e-3 and its GSPMD and unpartitioned
# steps by 6.7e-4 (one exp): HYBRID_BOUNDS, 1.5x the port's reading,
# held for both of the port's steps, and the partitioned step held to
# the port's `mesh=None` one (`hold_to_plain`)
REF_RUNS = (("mamba2", "mamba2-370m", ("momentum",), 2, False),
            ("rgemma", "recurrentgemma-9b", ("momentum",), 1, False))
HYBRID_BOUNDS = (0.08, 0.998)
# (case, arch, config fields replaced, score dtype)
CASES = (("mamba2", "mamba2-370m", {}, "float32"),
         ("rgemma", "recurrentgemma-9b", {}, "float32"),
         ("narrow_conv", "mamba2-370m", {"conv_width": 3}, "float32"),
         ("odd_lru", "recurrentgemma-9b", {"lru_width": 65}, "float32"),
         ("bf16_scores", "mamba2-370m", {}, "bfloat16"))
# masked leaves of a SMOKE model: mamba2's w_in, conv, w_out; the
# hybrid's two rec blocks (w_x, w_y, conv, w_rg, w_ri, w_out, the MLP's
# 3: 9 each), its attention block (4 + 3) and its rec tail (9)
MASKED = {"mamba2-370m": 3, "recurrentgemma-9b": 34}


def _local(state, sh):
    """This rank's block of each leaf of a host-global state."""
    return {k: tree.tree_map(lambda x, h: None if x is None else h.local(x),
                             v, sh[k])
            for k, v in state.items() if k in sh and k != "step"}


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
                plain = mt._clone(host)
                pfn = steps.make_train_step(
                    api, steps.StepConfig(lam=1.0, lr=LR, seed=SEED,
                                          optimizer=opt))
                for i in range(2):
                    pre = f"{run}/batch{i}/"
                    batch = {k[len(pre):]: torch.from_numpy(v)
                             for k, v in arrs.items() if k.startswith(pre)}
                    st, m = fn(st, mt._local_batch(batch, mesh))
                    out[f"{tag}/loss/{i}"] = m["loss"].numpy()
                    if i < held:
                        plain, _ = pfn(plain, batch)
                    if i + 1 == held:
                        mt._blocks(tag, st, sh, host, out)
                        mt._blocks(f"{tag}_plain", _local(plain, sh), sh,
                                   host, out)
        for name, arch, over, dtype in CASES:
            api = mt._api(arch, over)
            host = mt._start(api, getattr(torch, dtype))
            sh = steps.fed_state_shardings(host, mesh)
            if name == "odd_lru":
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
                mt._blocks(f"{name}/{key}", _local(state, sh), sh, host, out)
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


def _f32_ulp(a, b):
    """One f32 ulp of the larger magnitude of a and b, elementwise."""
    return np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))


def hold_to_plain(got, mesh, plain, start, dtype, what):
    """The blocks under `mesh` against those under `plain` (the port's
    `mesh=None` step from the same state; `start` the state before it):
    on f32 scores each score's update within SELF_BOUNDS[0] of its own
    size plus the score's f32 ulp (an update read back as s1 - s0 keeps
    only the bits above the score's ulp: recurrentgemma's tail MLP moves
    its scores by little, and its updates' relative norm reads 1.4e-3
    where its moments, the step's gradient, read 2.4e-5) and their
    cosine above SELF_BOUNDS[1]; moments and floats within SELF_BOUNDS;
    on bf16 scores each score within one bf16 ulp and the bf16 moments
    within BF16_MOMENT_BOUNDS."""
    leaves = mt._leaves(got, mesh)
    assert leaves and leaves == mt._leaves(got, plain), what
    for leaf in leaves:
        want, have = got[f"{plain}/{leaf}"], got[f"{mesh}/{leaf}"]
        s0 = got[f"{start}/{leaf}"]
        bf16 = dtype == "bfloat16" and not leaf.startswith("floats")
        if bf16 and leaf.startswith("scores"):
            assert mt._bf16_ulps(want, have) <= 1, (what, leaf)
            continue
        rel, cos = mt._agree(want - s0, have - s0)
        bound = mt.BF16_MOMENT_BOUNDS if bf16 else mt.SELF_BOUNDS
        if leaf.startswith("scores"):
            tol = bound[0] * np.abs(want - s0) + _f32_ulp(want, have)
            assert (np.abs(have - want) <= tol).all(), (what, leaf, rel)
            assert cos >= bound[1], (what, leaf, cos)
            continue
        assert rel <= bound[0] and cos >= bound[1], (what, leaf, rel, cos)


@pytest.mark.parametrize("run", [r[0] for r in REF_RUNS])
def test_two_steps_equal_the_reference_shard_by_shard(mesh_run, run):
    """Every rank's blocks against its device's shards after the run's
    held step (REF_RUNS): the same leaves and block indices (a conv
    leaf's W taps on "data", its C on "model"), both steps' losses within
    LOSS_RTOL; mamba2's every leaf's change within chip_smoke's f32
    backward bounds after both steps; recurrentgemma's within
    HYBRID_BOUNDS after its first, the port's own `mesh=None` step held
    there too, and the partitioned blocks held to `mesh=None`'s
    (`hold_to_plain`)."""
    port, _, want, arrs = mesh_run
    held = dict((r[0], r[3]) for r in REF_RUNS)[run]
    max_rel, min_cos = (mt._chip_smoke().BACKWARD_BOUNDS["f32"]
                        if run == "mamba2" else HYBRID_BOUNDS)
    tag = f"{run}/momentum"
    leaves = mt._leaves(port[0], tag)
    assert leaves == sorted(k[len(tag) + 1:-len("/0/index")] for k in want
                            if k.startswith(tag + "/")
                            and k.endswith("/0/index"))
    assert {k.split("/")[0] for k in leaves} == {"scores", "floats", "opt_m"}
    # rank 0's block of a conv leaf: taps 0.. of W / 2, channels 0.. of
    # C / 2 (mamba2: C = 128 + 2 * 16; the hybrid: lru_width 64)
    conv, L, C = {"mamba2": ("layers/conv/w_conv", 2, 160),
                  "rgemma": ("groups/b0_rec/conv/w_conv", 1, 64)}[run]
    idx = port[0][f"{tag}/scores/{conv}/index"]
    assert idx.tolist() == [[0, 1], [0, L], [0, 2], [0, C // 2]]
    for r in range(8):
        for i in range(2):
            np.testing.assert_allclose(port[r][f"{tag}/loss/{i}"],
                                       want[f"{tag}/loss/{i}"],
                                       rtol=mt.LOSS_RTOL)
        starts = {}
        for leaf in leaves:
            idx = port[r][f"{tag}/{leaf}/index"]
            assert np.array_equal(idx, want[f"{tag}/{leaf}/{r}/index"]), (
                leaf, r)
            key, path = leaf.split("/", 1)
            start = arrs.get(f"{tag}/{key}/{path}")
            start = (np.zeros_like(want[f"{tag}/{leaf}/{r}"]) if start is None
                     else start[tuple(slice(a, b) for a, b in idx)])
            starts[f"start/{leaf}"] = start
            for side in (tag, f"{tag}_plain"):
                rel, cos = mt._agree(want[f"{tag}/{leaf}/{r}"] - start,
                                     port[r][f"{side}/{leaf}"] - start)
                assert rel <= max_rel and cos >= min_cos, (side, leaf, r,
                                                           rel, cos)
        hold_to_plain(dict(port[r], **starts), tag, f"{tag}_plain", "start",
                      "float32", (run, held, r))


def test_placed_leaves_draw_the_global_masks(mesh_run):
    """On every rank, each placed masked leaf of both archs and of the
    hybrid with lru_width 65 (a conv leaf's block at the global leaf's
    per-layer offsets moved by its first tap row and channel, n_logical
    = C) materializes to the global leaf's block of effective weights
    bit for bit."""
    port, _, _, _ = mesh_run
    for r in range(8):
        for run, arch in (("mamba2", "mamba2-370m"),
                          ("rgemma", "recurrentgemma-9b"),
                          ("odd_lru", "recurrentgemma-9b")):
            got = port[r][f"{run}/placed_masks"]
            assert len(got) == MASKED[arch] and got[:, 1].all(), (r, run,
                                                                  got)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_partitioned_step_equals_the_plain_step(mesh_run, case):
    """The partitioned step against `mesh=None` from one state, one step,
    block by block on every rank: the global mean loss within LOSS_RTOL,
    every leaf's update as `hold_to_plain` holds it."""
    port, _, _, _ = mesh_run
    dtype = dict((c[0], c[3]) for c in CASES)[case]
    for r in range(8):
        loss = port[r][f"{case}/loss"]
        np.testing.assert_allclose(loss[1], loss[0], rtol=mt.LOSS_RTOL)
        hold_to_plain(port[r], f"{case}/mesh", f"{case}/plain",
                      f"{case}/start", dtype, (case, r))


@pytest.mark.parametrize("case, arch", [("mamba2", "mamba2-370m"),
                                        ("rgemma", "recurrentgemma-9b")])
def test_recorded_wire_equals_the_closed_form(mesh_run, case, arch):
    """One SMOKE step on every rank: the collectives it recorded, by kind,
    axes, type and operand size, equal chip_smoke's `block_sites` from
    the shapes (the closed form the card's mesh and dry-run phases hold
    mamba2-370m and recurrentgemma-9b to), its conv leaves' among them:
    each layer's taps (2 of W = 4) of its 80 (mamba2) or 32 channels
    gathered over "data" (w and s), ds reduce-scattered there, and the
    32 x C/2 output and dx channels gathered over "model"."""
    from repro_torch.launch import dryrun
    _, calls, _, _ = mesh_run
    cs = mt._chip_smoke()
    host = mt._start(mt._api(arch))
    shape = dict(zip(AXES, MESH))
    tokens = B // MESH[1] * S
    want, conv = cs.block_sites(
        host, steps.fed_state_shardings(host, cs.stub_mesh(shape)), shape,
        tokens, 1, act="float32")
    cl = {"mamba2": 80, "rgemma": 32}[case]
    layers = {"mamba2": 2, "rgemma": 4}[case]
    assert conv == {
        "all-gather data bfloat16": {str(2 * cl): layers},
        "all-gather data float32": {str(2 * cl): layers},
        "reduce-scatter data float32": {str(4 * cl): layers},
        "all-gather model float32": {str(tokens * cl): 2 * layers}}
    for r in range(8):
        got = {}
        for prim, dtype, axes, n in calls[r][case]:
            key = f"{dryrun.HLO_KINDS[prim]} {'x'.join(axes)} {dtype}"
            got.setdefault(key, {})
            got[key][str(n)] = got[key].get(str(n), 0) + 1
        assert got == want, r


def test_fallbacks_are_what_they_claim(mesh_run):
    """conv_width 3 does not split over the 2 data ranks: every rank holds
    all 3 taps of its channels and all-reduces their ds over "data" (3 x
    80 a layer); lru_width 65 does not split over the 2 model ranks:
    every rank holds all 65 channels (and all of w_rg's 65 columns)."""
    port, calls, _, _ = mesh_run
    idx = port[0]["narrow_conv/mesh/scores/layers/conv/w_conv/index"]
    assert idx.tolist() == [[0, 1], [0, 2], [0, 3], [0, 80]]
    psums = [c for c in calls[0]["narrow_conv"]
             if c[:3] == ["psum", "float32", ["data"]]]
    assert [c[3] for c in psums].count(3 * 80) == 2      # 2 layers
    idx = port[0]["odd_lru/mesh/scores/groups/b0_rec/conv/w_conv/index"]
    assert idx[-1].tolist() == [0, 65]
    idx = port[0]["odd_lru/mesh/scores/groups/b0_rec/w_rg/index"]
    assert idx[-2:].tolist() == [[0, 65], [0, 65]]


def test_world_of_one_equals_the_plain_step(tmp_path):
    """On a (1, 1, 1) mesh the partitioned step of both SMOKE archs is the
    `mesh=None` step bit for bit, two steps (scores, moments, floats,
    losses), and so are the torchrun entry's `--arch mamba2-370m` steps;
    one thread, so every CPU reduction sums in one order."""
    import torch.distributed as dist
    from repro_torch.launch import mesh_round
    from repro_torch.runtime import elastic
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mesh = mt._world_of_one(tmp_path)
    try:
        for arch in ("mamba2-370m", "recurrentgemma-9b"):
            api = mt._api(arch)
            host = mt._start(api)
            cfg = steps.StepConfig(lam=1.0, lr=LR, seed=SEED)
            sh = steps.fed_state_shardings(host, mesh)
            a = mt._clone(host)
            b = elastic.reshard_server(mt._clone(host), sh)
            fa = steps.make_train_step(api, cfg)
            fb = steps.make_train_step(api, cfg, mesh, sh)
            for i in range(2):
                batch = mt._batch(api, 60 + i)
                a, ma = fa(a, batch)
                b, mb = fb(b, batch)
                assert torch.equal(ma["loss"], mb["loss"]), (arch, i)
            for key in ("scores", "floats", "opt_m"):
                for x, y in zip(tree.leaves(a[key]), tree.leaves(b[key])):
                    assert (x is None and y is None) or torch.equal(x, y), (
                        arch, key)
        args = mesh_round.parse_args(["--arch", "mamba2-370m", "--smoke",
                                      "--device", "cpu", "--steps", "2"])
        api, start = mesh_round.global_state(args.arch, args.cohorts,
                                             smoke=True)
        out = mesh_round.run(args, mesh, (api, start))
        st = elastic.reshard_server(start, "cpu")
        plain = steps.make_train_step(api, mesh_round.step_config(args))
        losses = []
        for i in range(2):
            st, m = plain(st, mesh_round.step_batch(args, api, i, "cpu"))
            losses.append(float(m["loss"]))
        st, _ = steps.make_round_step(api, mesh_round.step_config(args),
                                      codec=mesh_round.CODEC)(st)
        assert out["losses"] == losses
        for key in ("scores", "opt_m"):
            for x, y in zip(tree.leaves(st[key]),
                            tree.leaves(out["state"][key])):
                assert (x is None and y is None) or torch.equal(x, y), key
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", ("sample", "threshold"))
def test_channel_block_draws_the_global_channels(mode):
    """`ops.masked_conv1d` (kernels 8-9's plain versions on the CPU) on a
    channel block c0:c1 of a (W, C) conv leaf, its offset moved by c0 and
    n_logical = C: the forward and the flipped dx (kernel 8) are the
    global conv's channels bit for bit (a depthwise conv sums each
    channel's taps on its own), the ds (kernel 9) within f32 rounding
    (its plain version sums the B*S rows of a narrower tensor in another
    order), at a layer offset where the block's indices wrap past 2**32;
    without n_logical the block draws another stream."""
    gen = torch.Generator().manual_seed(13)
    W, C, c0, c1 = 4, 160, 80, 120
    x = torch.randn(2, 16, C, generator=gen).requires_grad_()
    w = torch.randn(W, C, generator=gen).to(torch.bfloat16)
    s = 2.0 * torch.randn(W, C, generator=gen)
    g = torch.randn(2, 16, C, generator=gen)
    seed = masking.mask_stream_seed(1, 0, 2, 0, run_seed=SEED)
    off = (1 << 32) - 2 * C - c0 - 5            # wraps inside the block
    sf = s.clone().requires_grad_()
    if mode == "sample":
        y = ops.masked_conv1d(x, w, sf, seed, off)
    else:
        y = ops.masked_conv1d_threshold(x, w, sf, 0.45)
    (y * g).sum().backward()
    xb = x.detach()[..., c0:c1].clone().requires_grad_()
    sb = s[:, c0:c1].clone().requires_grad_()
    wb = w[:, c0:c1].contiguous()
    if mode == "sample":
        yb = ops.masked_conv1d(xb, wb, sb, seed, (off + c0) & 0xFFFFFFFF,
                               n_logical=C)
    else:
        yb = ops.masked_conv1d_threshold(xb, wb, sb, 0.45)
    (yb * g[..., c0:c1]).sum().backward()
    assert torch.equal(yb, y[..., c0:c1])
    assert torch.equal(xb.grad, x.grad[..., c0:c1])
    want = sf.grad[:, c0:c1]
    torch.testing.assert_close(sb.grad, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
    if mode == "sample":
        assert off + c0 < 2 ** 32 < off + (W - 1) * C + c1
        other = ops.masked_conv1d(xb.detach(), wb, sb.detach(), seed,
                                  (off + c0) & 0xFFFFFFFF)
        assert not torch.equal(other, y.detach()[..., c0:c1])


def test_hybrid_plan_places_every_leaf_as_a_2d_body():
    """recurrentgemma's SMOKE state on a (2, 2, 2) mesh's rank 0: every
    masked leaf's layout is a `BlockLayout`, none an `ExpertLayout` (no
    group leaf is taken for a 5-D expert leaf), and the conv leaves'
    offsets are the global stream's per-layer offsets moved by the
    block's first tap row and channel (r0 = 0 and c0 = 0 at rank 0; at
    the last rank r0 = W / 2 taps and c0 = C / 2)."""
    from repro_torch.launch import partition
    from repro_torch.runtime import elastic
    api = mt._api("recurrentgemma-9b")
    host = mt._start(api)
    for coords in ((0, 0, 0), (1, 1, 1)):
        class Mesh:
            shape, axis_names = dict(zip(AXES, MESH)), AXES
            device = torch.device("cpu")

            def group(self, axes):
                return None
        Mesh.coords = dict(zip(AXES, coords))
        sh = steps.fed_state_shardings(host, Mesh())
        st = elastic.reshard_server(mt._clone(host), sh)
        plan = partition.TrainPlan(Mesh(), st, sh)
        assert len(plan.layouts) == MASKED["recurrentgemma-9b"]
        assert all(type(lay) is partition.BlockLayout
                   for lay, _, _ in plan.layouts.values())
        paths = [p for p, _ in tree.flatten_with_paths(host["scores"])]
        convs = [i for i, p in enumerate(paths) if p.endswith("w_conv")]
        assert len(convs) == 3                 # b0_rec, b1_rec, the tail
        for i in convs:
            lay, off, n = plan.layouts[i]
            L, W, C = tree.leaves(host["scores"])[i].shape[1:]
            r0, c0 = coords[1] * W // 2, coords[2] * C // 2
            assert n == C and lay.cols and lay.rows.gathers
            assert off.tolist() == [(l * W * C + r0 * C + c0) & 0xFFFFFFFF
                                    for l in range(L)]
