"""Crash-restart chaos smoke of the port: kill the trainer mid-run,
resume, and check crash consistency (`tools/chaos_smoke.py` of the JAX
package).

    python -m repro_torch.tools.chaos_smoke [--device cpu]
    python -m repro_torch.tools.chaos_smoke --tree [--device cpu]

Drives `python -m repro_torch.launch.train` as a real subprocess with
`--ckpt-dir` and faults on (by default the SMOKE internlm2 config, 12
steps, a round every 4, 4 cohorts, --fail-prob 0.3 --quorum-frac 0.8),
and:

  1. runs the same command uninterrupted into a directory of its own;
  2. launches it again, waits for the FIRST durable round (a checkpoint
     and the ledger sidecar on disk) and SIGKILLs it: no atexit, no
     flush, a coordinator crash;
  3. relaunches the identical command to completion and asserts STEP
     CONTINUITY (it resumes at the checkpointed step), a MONOTONE
     CommLedger (it only grows, and counts each round once) and, beyond
     the reference, that every step's loss and round metrics after the
     resume point and the final checkpoint equal the uninterrupted
     run's bit for bit (`history.jsonl`, `load_raw`);
  4. with `--relaunch-cohorts N`, relaunches once more with N cohorts
     and two more rounds: the structure no longer matches, so the run
     must take the theta-only restore and continue the step.

`--layers N` cuts the model's depth: each launcher process is then the
scripted `launch.train.run(dataclasses.replace(cfg, n_layers=N), args)`
(this module's `child` mode), since the command line has no depth flag.

`--tree` runs the aggregator-tree gate instead: it drives
`python -m repro_torch.runtime.agg_tree` (a `TreeRoundEngine` with edge
crash and partition faults and a crash-consistent save every tick),
SIGKILLs it after the first commit is durable, resumes, and asserts
EXACTLY-ONCE commits: every version the killed run announced was saved
first, the resumed run continues strictly after the restored version
with a monotone event `seq`, the union of committed versions equals an
uninterrupted run's, and the final theta digest matches it.

Exit code 0 = pass; a failed check prints FAIL and exits 1.  `main`
returns a summary of what it checked (seconds of each phase included).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[2]


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _train_args(args, ckpt_dir: str, cohorts=None, steps=None) -> list:
    out = ["--arch", args.arch, "--steps", str(steps or args.steps),
           "--round-every", str(args.round_every),
           "--cohorts", str(cohorts or args.cohorts),
           "--batch", str(args.batch), "--seq", str(args.seq),
           "--fail-prob", str(args.fail_prob),
           "--quorum-frac", str(args.quorum_frac),
           "--device", args.device, "--ckpt-dir", ckpt_dir]
    if args.tree_fanout:
        out += ["--tree-fanout", str(args.tree_fanout),
                "--agg-fault-prob", str(args.agg_fault_prob)]
    if args.smoke:
        out.append("--smoke")
    return out


def _train_cmd(args, ckpt_dir: str, **kw) -> list:
    targs = _train_args(args, ckpt_dir, **kw)
    if args.layers:
        return [sys.executable, "-m", "repro_torch.tools.chaos_smoke",
                "child", str(args.layers)] + targs
    return [sys.executable, "-m", "repro_torch.launch.train"] + targs


def _child(argv) -> None:
    """`child LAYERS <train args>`: the launcher with the depth cut.  It
    appends the kernels' launch counts of its process, with the step it
    started at, to `launches.jsonl` in the checkpoint directory."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train
    targs = train.parse_args(argv[1:])
    cfg = get_config(targs.arch, smoke=targs.smoke)
    out = train.run(dataclasses.replace(cfg, n_layers=int(argv[0])), targs)
    with open(os.path.join(targs.ckpt_dir, "launches.jsonl"), "a") as f:
        f.write(json.dumps({"start": out["start"], "steps": targs.steps,
                            "cohorts": targs.cohorts,
                            "launches": dict(dispatch.LAUNCHES)}) + "\n")


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _history(ckpt_dir: str) -> dict:
    """{step: record}, the last record of each step (a killed run may
    have logged steps past its last checkpoint; the resume logs them
    again)."""
    out = {}
    with open(os.path.join(ckpt_dir, "history.jsonl")) as f:
        for line in f:
            if line.strip():
                r = json.loads(line)
                out[r["step"]] = r
    return out


def _run(cmd, timeout: float) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                          timeout=timeout)


def _same_checkpoints(a: str, b: str) -> int:
    """Asserts the latest checkpoints of two directories hold equal
    leaves; returns how many."""
    import torch

    from repro_torch.ckpt import checkpoint as ckptlib
    ra, ma = ckptlib.load_raw(a)
    rb, mb = ckptlib.load_raw(b)
    if ma["step"] != mb["step"] or sorted(ra) != sorted(rb):
        _fail(f"final checkpoints differ in step or leaves: {ma['step']} "
              f"vs {mb['step']}")
    for k in ra:
        same = (ra[k] is None and rb[k] is None) or (
            ra[k] is not None and rb[k] is not None
            and torch.equal(ra[k], rb[k]))
        if not same:
            _fail(f"final checkpoint leaf {k} differs from the "
                  "uninterrupted run's")
    return len(ra)


def trainer_main(args) -> dict:
    root = tempfile.mkdtemp(prefix="chaos_smoke_", dir=args.work_dir)
    ref_dir, ckpt_dir = os.path.join(root, "ref"), os.path.join(root, "run")
    ledger_path = os.path.join(ckpt_dir, "comm_ledger.json")
    summary = {"seconds": {}}
    try:
        print("[1/4] uninterrupted reference run", flush=True)
        t0 = time.time()
        ref = _run(_train_cmd(args, ref_dir), args.timeout)
        summary["seconds"]["reference"] = time.time() - t0
        if ref.returncode != 0:
            _fail(f"reference run failed (rc={ref.returncode}):\n"
                  + ref.stdout[-2000:] + ref.stderr[-2000:])

        print(f"[2/4] launch + kill after first commit (ckpt={ckpt_dir})",
              flush=True)
        t0 = time.time()
        p = subprocess.Popen(_train_cmd(args, ckpt_dir), env=_env(),
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        deadline = time.time() + args.timeout
        try:
            while time.time() < deadline:
                if p.poll() is not None:
                    _fail(f"trainer exited (rc={p.returncode}) before the "
                          "kill: round too fast or crashed; output:\n"
                          + p.stdout.read().decode()[-4000:])
                if (os.path.exists(os.path.join(ckpt_dir, "LATEST"))
                        and os.path.exists(ledger_path)):
                    break
                time.sleep(0.05)
            else:
                _fail("no checkpoint appeared within the timeout")
            os.kill(p.pid, signal.SIGKILL)   # a real coordinator crash
            p.wait(timeout=30)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            p.stdout.close()
        summary["seconds"]["killed"] = time.time() - t0
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            killed_at = int(f.read().strip())
        pre = _read_json(ledger_path)
        print(f"      killed after step {killed_at}; ledger rounds="
              f"{pre['rounds']} uplink_bits={pre['uplink_bits']:.0f}",
              flush=True)
        if killed_at < args.round_every:
            _fail(f"checkpoint step {killed_at} before the first round")

        print("[3/4] resume to completion", flush=True)
        t0 = time.time()
        out = _run(_train_cmd(args, ckpt_dir), args.timeout)
        summary["seconds"]["resumed"] = time.time() - t0
        sys.stdout.write(out.stdout)
        if out.returncode != 0:
            _fail(f"resumed run failed (rc={out.returncode}):\n"
                  + out.stderr[-2000:])
        m = re.search(r"resumed at step (\d+)", out.stdout)
        if not m:
            _fail("resumed run did not restore the checkpoint (no "
                  "'resumed at step' line)")
        resumed = int(m.group(1))
        if resumed != killed_at:
            _fail(f"step discontinuity: killed at {killed_at}, resumed at "
                  f"{resumed}")
        if not re.search(r"resumed ledger:", out.stdout):
            _fail("CommLedger was not resumed")
        if "done" not in out.stdout:
            _fail("resumed run did not reach 'done'")
        post = _read_json(ledger_path)
        for k in ("uplink_bits", "downlink_bits", "root_bits", "rounds"):
            if post[k] < pre[k]:
                _fail(f"ledger went BACKWARD across the crash: {k} "
                      f"{pre[k]} -> {post[k]}")
        if post["rounds"] <= pre["rounds"]:
            _fail(f"no rounds after resume ({pre['rounds']} -> "
                  f"{post['rounds']})")
        expect_rounds = args.steps // args.round_every
        if post["rounds"] != expect_rounds:
            _fail(f"resumed run re-counted rounds: total {post['rounds']} "
                  f"!= {expect_rounds}")
        if post != _read_json(os.path.join(ref_dir, "comm_ledger.json")):
            _fail("final ledger differs from the uninterrupted run's")
        # beyond the reference: the resumed run IS the uninterrupted one
        got, want = _history(ckpt_dir), _history(ref_dir)
        later = [s for s in sorted(want) if s > resumed]
        if sorted(got) != sorted(want):
            _fail(f"history steps {sorted(got)} != {sorted(want)}")
        for s in later:
            if got[s] != want[s]:
                _fail(f"step {s} differs from the uninterrupted run: "
                      f"{got[s]} vs {want[s]}")
        n_leaves = _same_checkpoints(ckpt_dir, ref_dir)
        summary.update(killed_at=killed_at, resumed=resumed,
                       rounds=post["rounds"], compared_steps=later,
                       leaves=n_leaves, ledger=post, root=root)
        print(f"OK: killed at step {killed_at}, resumed at {resumed}, "
              f"ledger {pre['rounds']} -> {post['rounds']} rounds "
              f"monotone; steps {later} and {n_leaves} checkpoint leaves "
              f"equal the uninterrupted run's", flush=True)

        if args.relaunch_cohorts:
            print(f"[4/4] relaunch with --cohorts {args.relaunch_cohorts}",
                  flush=True)
            t0 = time.time()
            more = args.steps + 2 * args.round_every
            out = _run(_train_cmd(args, ckpt_dir,
                                  cohorts=args.relaunch_cohorts,
                                  steps=more), args.timeout)
            summary["seconds"]["relaunch"] = time.time() - t0
            sys.stdout.write(out.stdout)
            if out.returncode != 0:
                _fail(f"relaunch failed (rc={out.returncode}):\n"
                      + out.stderr[-2000:])
            m = re.search(r"theta-only partial restore at step (\d+)",
                          out.stdout)
            if not m or int(m.group(1)) != args.steps:
                _fail("relaunch with another cohort count did not take the "
                      f"theta-only restore at step {args.steps}")
            hist = _history(ckpt_dir)
            if max(hist) != more or "done" not in out.stdout:
                _fail(f"relaunch did not continue to step {more}")
            summary["relaunch_steps"] = [s for s in sorted(hist)
                                         if s > args.steps]
            print(f"OK: --cohorts {args.relaunch_cohorts} took the "
                  f"theta-only restore at step {args.steps} and ran to "
                  f"step {more}", flush=True)
    finally:
        if not args.keep:
            shutil.rmtree(root, ignore_errors=True)
    return summary


# ---------------------------------------------------------------------------
# --tree: the aggregator tree's exactly-once gate
# ---------------------------------------------------------------------------


def _tree_cmd(args, ckpt_dir: str, marker: str = "",
              tick_sleep: float = 0.0) -> list:
    cmd = [sys.executable, "-m", "repro_torch.runtime.agg_tree",
           "--ticks", "8", "--clients", "8", "--fanout", "2",
           "--agg-fault-prob", "0.3", "--quorum-frac", "0.75",
           "--deadline", "2", "--seed", "0", "--ckpt-dir", ckpt_dir,
           "--device", args.device]
    if marker:
        cmd += ["--marker", marker]
    if tick_sleep:
        cmd += ["--tick-sleep", str(tick_sleep)]
    return cmd


def _commits(text: str) -> list:
    """[(version, seq)] in print order."""
    return [(int(v), int(s)) for v, s in
            re.findall(r"commit v=(\d+) seq=(\d+)", text)]


def _digest(text: str):
    m = re.search(r"theta digest ([0-9a-f]{8}) version (\d+)", text)
    return m and (m.group(1), int(m.group(2)))


def tree_main(args) -> dict:
    root = tempfile.mkdtemp(prefix="chaos_tree_", dir=args.work_dir)
    summary = {"seconds": {}}
    try:
        print("[1/3] uninterrupted reference run", flush=True)
        t0 = time.time()
        ref = _run(_tree_cmd(args, os.path.join(root, "ref")), args.timeout)
        summary["seconds"]["reference"] = time.time() - t0
        if ref.returncode != 0:
            _fail(f"reference run failed (rc={ref.returncode}):\n"
                  + ref.stdout[-2000:] + ref.stderr[-2000:])
        ref_commits = _commits(ref.stdout)
        ref_digest = _digest(ref.stdout)
        if not ref_commits or ref_digest is None:
            _fail("reference run produced no commits/digest:\n" + ref.stdout)
        print(f"      reference: versions {[v for v, _ in ref_commits]}, "
              f"digest {ref_digest[0]}", flush=True)

        print("[2/3] launch + SIGKILL after first durable commit",
              flush=True)
        t0 = time.time()
        ckpt_dir = os.path.join(root, "run")
        os.makedirs(ckpt_dir)
        marker = os.path.join(ckpt_dir, "COMMITTED")
        p = subprocess.Popen(_tree_cmd(args, ckpt_dir, marker,
                                       tick_sleep=0.4),
                             env=_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        deadline = time.time() + args.timeout
        try:
            while time.time() < deadline:
                if p.poll() is not None:
                    _fail(f"tree CLI exited (rc={p.returncode}) before "
                          "the kill; output:\n" + p.stdout.read().decode())
                if os.path.exists(marker):
                    break
                time.sleep(0.1)
            else:
                _fail("no durable commit within the timeout")
            # let it get about mid-tick so the kill lands between saves
            time.sleep(0.2)
            os.kill(p.pid, signal.SIGKILL)
            p.wait(timeout=30)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        out1 = p.stdout.read().decode()
        p.stdout.close()
        summary["seconds"]["killed"] = time.time() - t0
        v1 = _commits(out1)
        print(f"      killed; announced versions {[v for v, _ in v1]}",
              flush=True)
        if not v1:
            _fail("marker existed but no commit line was printed")

        print("[3/3] resume + assert exactly-once commits", flush=True)
        t0 = time.time()
        out = _run(_tree_cmd(args, ckpt_dir), args.timeout)
        summary["seconds"]["resumed"] = time.time() - t0
        sys.stdout.write(out.stdout)
        if out.returncode != 0:
            _fail(f"resumed run failed (rc={out.returncode}):\n"
                  + out.stdout[-2000:] + out.stderr[-2000:])
        m = re.search(r"resumed at tick (\d+) \(version (\d+), seq (\d+)\)",
                      out.stdout)
        if not m:
            _fail("resumed run did not restore the bundle (no 'resumed at "
                  "tick' line)")
        v_r, seq_r = int(m.group(2)), int(m.group(3))
        v2 = _commits(out.stdout)
        digest2 = _digest(out.stdout)
        # every commit the killed run ANNOUNCED was saved first ...
        if v_r < max(v for v, _ in v1):
            _fail(f"announced commit v{max(v for v, _ in v1)} was not "
                  f"durable (resumed at v{v_r})")
        # ... and the resumed run never re-commits an announced version
        if any(v <= v_r for v, _ in v2):
            _fail(f"version replayed after restore: resumed at v{v_r}, "
                  f"recommitted {[v for v, _ in v2 if v <= v_r]}")
        seqs = [s for _, s in v2]
        if seqs != sorted(seqs) or (seqs and seqs[0] <= seq_r):
            _fail(f"event seq not monotone across the crash: restored seq "
                  f"{seq_r}, then {seqs}")
        got = sorted({v for v, _ in v1 if v <= v_r} | {v for v, _ in v2})
        want = sorted({v for v, _ in ref_commits})
        if got != want:
            _fail(f"committed versions diverged: {got} vs reference {want}")
        if digest2 is None:
            _fail("resumed run printed no theta digest")
        if digest2 != ref_digest:
            _fail(f"theta digest diverged across the crash: {digest2} vs "
                  f"reference {ref_digest}")
        summary.update(killed_at=max(v for v, _ in v1), resumed=v_r,
                       versions=got, digest=digest2[0])
        print(f"OK: killed at v{max(v for v, _ in v1)}, resumed at v{v_r}, "
              f"versions {got} == reference, digest {digest2[0]} matches",
              flush=True)
    finally:
        if not args.keep:
            shutil.rmtree(root, ignore_errors=True)
    return summary


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="kill-and-resume checks of the port's launcher (and, "
                    "with --tree, of the aggregator-tree engine)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="wall-clock limit of each phase (s)")
    ap.add_argument("--tree", action="store_true",
                    help="run the aggregator-tree exactly-once gate instead "
                         "of the trainer gate")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; the children raise without a "
                         "card) or cpu")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--full-size", dest="smoke", action="store_false",
                    help="the published config instead of its SMOKE cut")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (0 = its own)")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--round-every", type=int, default=4)
    ap.add_argument("--cohorts", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--fail-prob", type=float, default=0.3)
    ap.add_argument("--quorum-frac", type=float, default=0.8)
    ap.add_argument("--tree-fanout", type=int, default=0)
    ap.add_argument("--agg-fault-prob", type=float, default=0.0)
    ap.add_argument("--relaunch-cohorts", type=int, default=0,
                    help="afterwards relaunch with this many cohorts and "
                         "check the theta-only restore (0 = skip)")
    ap.add_argument("--work-dir", default=None,
                    help="parent of the run directories (default: the "
                         "system's temporary directory)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the run directories")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "child":
        _child(argv[1:])
        return {}
    args = parse_args(argv)
    from repro_torch.launch.train import resolve_device
    resolve_device(args.device)   # a card asked for and absent raises here
    return tree_main(args) if args.tree else trainer_main(args)


if __name__ == "__main__":
    main()
