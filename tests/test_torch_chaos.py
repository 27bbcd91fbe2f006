"""Checkpoint and restart of the port's launcher on the CPU (the SMOKE
internlm2 config): a run stopped after its first round and resumed from
its checkpoint equals an uninterrupted run bit for bit (every loss and
round metric, every leaf of the final state); a resize of the cohort
count takes the theta-only restore; `--agg-fault-prob` needs a tree;
the `alive` sequence of the fault flags is the reference
`FaultSimulator`'s (and `TreeTopology`'s); and the chaos tool's real
SIGKILL runs, of the launcher and of the aggregator-tree CLI, pass.
"""
import re

import numpy as np
import pytest
import torch

from repro.runtime import agg_tree as jagg_tree
from repro.runtime import fault as jfault

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.launch import train
from repro_torch.runtime import agg_tree
from repro_torch.tools import chaos_smoke
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

BASE = ["--smoke", "--device", "cpu", "--round-every", "2", "--cohorts", "3",
        "--batch", "2", "--seq", "16", "--fail-prob", "0.3", "--quorum-frac",
        "0.8", "--tree-fanout", "2", "--agg-fault-prob", "0.3"]
ALIVE = re.compile(r"step (\d+): .* alive=(\d+)/(\d+) edges=(\d+)/(\d+)")


def _equal_checkpoints(a, b):
    ra, ma = ckpt.load_raw(a)
    rb, mb = ckpt.load_raw(b)
    assert ma["step"] == mb["step"] and sorted(ra) == sorted(rb)
    for k in ra:
        assert (ra[k] is None and rb[k] is None) or torch.equal(ra[k],
                                                                rb[k]), k
    return ma


def test_resumed_run_equals_the_uninterrupted_one(tmp_path, capsys):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    full = train.main(BASE + ["--steps", "6", "--ckpt-dir", a])
    lines = [m for m in map(ALIVE.match, capsys.readouterr().out
                            .splitlines()) if m]
    # the fault flags' alive sequence: the reference simulator's, masked
    # by the reference tree topology's crashed edges
    sim = jfault.FaultSimulator(3, fail_prob=0.3, seed=17)
    pol = jfault.StragglerPolicy(quorum_frac=0.8)
    topo = jagg_tree.TreeTopology(3, 2, agg_fault_prob=0.3, seed=17)
    assert [int(m.group(1)) for m in lines] == [2, 4, 6]
    for m in lines:
        r = int(m.group(1)) // 2
        base = sim.sample_round(pol, round_idx=r)
        masked = topo.round_mask(base, r)
        want = masked if masked.any() else base
        assert int(m.group(2)) == int(want.sum()) and m.group(3) == "3"
        assert int(m.group(4)) == topo.surviving_edges(r)
        assert int(m.group(5)) == topo.n_edges
    first = train.main(BASE + ["--steps", "2", "--ckpt-dir", b])
    assert first["losses"] == full["losses"][:2]
    rest = train.main(BASE + ["--steps", "6", "--ckpt-dir", b])
    assert "resumed at step 2" in capsys.readouterr().out
    assert rest["start"] == 2
    assert rest["losses"] == full["losses"][2:]
    assert rest["rounds"] == full["rounds"][1:]
    assert rest["ledger"] == full["ledger"]
    assert _equal_checkpoints(a, b)["step"] == 6
    # another cohort count: the structure no longer matches
    more = train.main(BASE + ["--steps", "8", "--cohorts", "4",
                              "--ckpt-dir", b])
    out = capsys.readouterr().out
    assert "structure mismatch: theta-only partial restore at step 6" in out
    assert more["start"] == 6 and len(more["losses"]) == 2
    state, step = ckpt.restore_checkpoint(b, {"step": 0})
    assert step == 8 and state["step"] == 6 + 2 + 1


def test_agg_fault_prob_needs_a_tree():
    with pytest.raises(SystemExit):
        train.parse_args(["--smoke", "--agg-fault-prob", "0.3"])


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos_smoke.main(["--work-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        agg_tree._main(["--ckpt-dir", str(tmp_path)])


def test_chaos_smoke_kills_and_resumes_the_launcher(tmp_path):
    """Real subprocesses: an uninterrupted run, one SIGKILLed after its
    first durable round, its resumption (steps and checkpoint equal to
    the uninterrupted run's)."""
    out = chaos_smoke.main(["--device", "cpu", "--work-dir", str(tmp_path)])
    assert out["resumed"] == out["killed_at"] >= 4
    assert out["rounds"] == 3 and out["compared_steps"][-1] == 12


def test_chaos_smoke_tree_is_exactly_once(tmp_path):
    out = chaos_smoke.main(["--tree", "--device", "cpu", "--work-dir",
                            str(tmp_path)])
    assert out["versions"] == list(range(1, len(out["versions"]) + 1))
    assert out["resumed"] >= out["killed_at"] >= 1
