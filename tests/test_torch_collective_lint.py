"""The port's collective recorder, site classes and wire-purity rule
(`repro_torch.analysis.comm_model` / `collective_lint`) on fixtures built
here: one gloo rank in this process, collectives recorded as the round
issues them.  An f32 score all-gather, a uint8 mask all-gather and an
int32 mask all-gather each fire; packed int32 words (rows of ceil(n/32)),
the float sidecar and a scalar metric pass.  Every public tensor
collective of torch.distributed is recorded (an f32 score row through
any of them fires), an object collective raises inside the recorder, and
its check catches a collective issued below the public functions.  The
round's tables against the reference's: `tests/test_torch_mesh_round.py`.
"""
import inspect
from datetime import timedelta

import pytest
import torch
import torch.distributed as dist

from repro_torch.analysis import collective_lint, comm_model
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

N = 4096                                   # a mask leaf's elements


@pytest.fixture
def mesh(tmp_path):
    meshlib.init("cpu", store=dist.FileStore(str(tmp_path / "store"), 1),
                 rank=0, world_size=1, timeout=timedelta(seconds=60))
    try:
        yield meshlib.make_debug_pod_mesh()
    finally:
        dist.destroy_process_group()


def _state():
    z = lambda *s: torch.zeros(s, device="meta")
    return {"scores": {"w": z(1, 64, 64)}, "floats": {"norm": z(1, 16)},
            "weights": {"w": z(64, 64)}, "opt_m": {"w": z(1, 64, 64)},
            "step": 0}


def _record(mesh, *calls):
    with comm_model.record_collectives(mesh) as sites:
        for c in calls:
            c()
    return sites


def _gather(mesh, t):
    out = torch.empty((t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype)
    return lambda: dist.all_gather_into_tensor(out, t,
                                               group=mesh.group("pod"))


def test_recorder_reads_axes_and_reference_names(mesh):
    x = torch.ones(3)
    sites = _record(
        mesh, _gather(mesh, torch.zeros((1, 128), dtype=torch.int32)),
        lambda: dist.all_reduce(x, group=mesh.group("pod")),
        lambda: dist.all_reduce(x, op=dist.ReduceOp.MAX),
        lambda: dist.all_reduce(torch.ones(()), group=mesh.group(
            mesh.axis_names)))
    assert sites == [
        comm_model.CollectiveSite("all_gather", ("pod",), (1, 128), "int32",
                                  4096),
        comm_model.CollectiveSite("psum", ("pod",), (3,), "float32", 96),
        comm_model.CollectiveSite("pmax", mesh.axis_names, (3,), "float32",
                                  96),
        comm_model.CollectiveSite("psum", mesh.axis_names, (), "float32",
                                  32)]
    # closed: the functions are torch.distributed's own again
    assert dist.all_reduce.__module__.startswith("torch.distributed")
    with pytest.raises(ValueError):
        mesh.group_axes(object())


def test_packed_words_sidecar_and_metric_pass(mesh):
    state = _state()
    sh = steps.fed_state_shardings(state, mesh)
    sites = _record(
        mesh, _gather(mesh, torch.zeros((1, N // 32), dtype=torch.int32)),
        lambda: dist.all_reduce(torch.ones(1, 16), group=mesh.group("pod")),
        lambda: dist.all_reduce(torch.ones(()), group=mesh.group(
            mesh.axis_names)))
    assert collective_lint.round_purity_findings(sites, state, sh,
                                                 mesh) == []
    model = comm_model.round_comm_model(sites, state, sh, mesh,
                                        steps.StepConfig())
    assert [r["role"] for r in model["sites"]] == ["uplink", "sidecar",
                                                   "metric"]
    assert model["uplink_bits"] == N and model["bpp_wire"] == 1.0
    # ring bytes: every axis of the mesh has size 1
    assert all(r["ring_send_bytes_per_device"] == 0.0
               for r in model["sites"])
    assert set(model["ring_bytes_per_axis"].values()) == {0.0}


@pytest.mark.parametrize("dtype, rule", [
    (torch.float32, "collective-f32-weight"),
    (torch.uint8, "collective-unpacked-mask"),
    (torch.int32, "collective-unpacked-mask")])
def test_unpacked_scores_and_masks_fire(mesh, dtype, rule):
    """A leaf's scores or mask on the wire, one cohort's (1, n) row: an
    int32 mask is no word stream (its row is n, not n/32), so it fires
    and classifies as an unpacked mask, not as the uplink."""
    state = _state()
    sh = steps.fed_state_shardings(state, mesh)
    sites = _record(mesh, _gather(mesh, torch.zeros((1, N), dtype=dtype)))
    found = collective_lint.round_purity_findings(sites, state, sh, mesh)
    assert [(f.rule, f.where) for f in found] == [(rule, "all_gather[pod]")]
    model = comm_model.round_comm_model(sites, state, sh, mesh,
                                        steps.StepConfig())
    assert model["sites"][0]["role"] == "mask-unpacked"


def test_ring_send_bytes():
    ring = comm_model._ring_send_bytes
    assert ring("all_gather", 100.0, 1) == 0.0
    assert ring("all_gather", 100.0, 4) == 300.0
    assert ring("psum", 100.0, 4) == 150.0
    assert ring("reduce_scatter", 100.0, 4) == 75.0
    assert ring("ppermute", 100.0, 4) == 100.0


# what each public collective sends on a world of one: (args) with `t`
# the operand and `o` an output of its shape
_CALLS = {
    "all_reduce": lambda t, o: (t,),
    "all_reduce_coalesced": lambda t, o: ([t],),
    "all_gather_into_tensor": lambda t, o: (o, t),
    "all_gather_single": lambda t, o: (o, t),
    "all_gather": lambda t, o: ([o], t),
    "all_gather_coalesced": lambda t, o: ([[o]], [t]),
    "reduce_scatter_tensor": lambda t, o: (o, t),
    "reduce_scatter_single": lambda t, o: (o, t),
    "reduce_scatter": lambda t, o: (o, [t]),
    "all_to_all_single": lambda t, o: (o, t),
    "all_to_all": lambda t, o: ([o], [t]),
    "broadcast": lambda t, o: (t, 0),
    "reduce": lambda t, o: (t, 0),
    "gather": lambda t, o: (t, [o], 0),
    "scatter": lambda t, o: (t, [o], 0),
    "send": lambda t, o: (t, 0),
    "isend": lambda t, o: (t, 0),
    "recv": lambda t, o: (t, 0),
    "irecv": lambda t, o: (t, 0),
    "batch_isend_irecv": lambda t, o: ([dist.P2POp(dist.isend, t, 0)],),
}
# a rank cannot send to itself: these are recorded, not issued
_P2P = ("send", "isend", "recv", "irecv", "batch_isend_irecv")
# what takes a process group and moves no payload
_NO_PAYLOAD = {"barrier", "monitored_barrier", "destroy_process_group",
               "get_backend", "get_backend_config", "get_global_rank",
               "get_group_rank", "get_process_group_ranks", "get_rank",
               "get_world_size", "new_subgroups", "shrink_group"}


def test_the_recorder_covers_every_public_collective():
    """Every public torch.distributed function that takes a process
    group is recorded, refused, or moves no payload: a collective a new
    release adds fails here until the recorder knows it."""
    names = {n for n in dir(dist) if not n.startswith("_")
             and inspect.isfunction(getattr(dist, n))
             and {"group", "async_op"} & set(
                 inspect.signature(getattr(dist, n)).parameters)}
    names.add("batch_isend_irecv")
    assert names <= (set(comm_model.RECORDED) | set(comm_model.UNRECORDABLE)
                     | _NO_PAYLOAD), names
    assert set(_CALLS) == set(comm_model.RECORDED)


@pytest.mark.parametrize("name", sorted(
    n for n in comm_model.RECORDED if hasattr(dist, n)))
def test_scores_through_any_collective_fire(mesh, name):
    """One cohort's f32 scores of a mask leaf sent through each public
    collective (a ``dist.broadcast`` among them) are recorded under the
    collective's name and fire `collective-f32-weight`; the check finds
    nothing unrecorded."""
    state = _state()
    sh = steps.fed_state_shardings(state, mesh)
    t = torch.ones((1, N))
    args = _CALLS[name](t, torch.empty_like(t))
    p2p = name in _P2P
    with comm_model.record_collectives(
            mesh, run=(lambda sites, call: None) if p2p else None,
            check=not p2p) as sites:
        getattr(dist, name)(*args)
    prim = comm_model.RECORDED[name][0] or "psum"
    assert sites == [comm_model.site_of(prim, mesh.axis_names, t)]
    found = collective_lint.round_purity_findings(sites, state, sh, mesh)
    assert [(f.rule, f.where) for f in found] == [
        ("collective-f32-weight", f"{prim}[{','.join(mesh.axis_names)}]")]


@pytest.mark.parametrize("name", comm_model.UNRECORDABLE)
def test_object_collectives_raise_inside_the_recorder(mesh, name):
    with comm_model.record_collectives(mesh):
        with pytest.raises(RuntimeError, match="cannot size"):
            getattr(dist, name)([None])
    assert getattr(dist, name).__module__.startswith("torch.distributed")


def test_check_catches_a_collective_below_the_public_functions(mesh):
    """``distributed_c10d.broadcast`` is the function the public name
    binds, called past the wrapper: recorded nothing, caught on close."""
    with pytest.raises(RuntimeError, match="went unrecorded"):
        with comm_model.record_collectives(mesh, check=True) as sites:
            dist.distributed_c10d.broadcast(torch.ones((1, N)), 0)
    assert sites == []
    with comm_model.record_collectives(mesh, check=True) as sites:
        dist.barrier()                     # no payload: nothing to record
    assert sites == []
