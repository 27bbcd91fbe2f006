"""AST source lint: the port's own rules over ``src/repro_torch/`` (the
reference's `repro.analysis.source_lint`).

Every rule takes explicit file paths, so a fixture can show it fires,
and returns `Finding`s; `run_all` applies the repo's layout.

Rules:

  * ``bare-seed`` -- no ``manual_seed(<int literal>)`` under
    ``launch/``: generators derive from the run seed (``--seed``, or
    `mask_stream_seed` of it), and a constant silently decouples a
    stream from it.  The twin of the reference's ``bare-prngkey``.
  * ``missing-oracle`` -- every kernel wrapper (a public function of
    ``kernels/masked_matmul.py`` / ``kernels/bitpack.py`` that calls
    ``build.launch``) has its plain version in ``kernels/ref.py`` and
    its kernel's name in ``dispatch.KERNELS``, and every
    ``kernels/csrc/*.cu`` is in ``kernels/build.py``'s ``SOURCES``;
    ``missing-kernel-boundary`` -- every wrapper runs inside
    ``dispatch.kernel_boundary``, without which the op walker would see
    the plain version's m * w as the program's own.
  * ``knob-doc`` -- every ``REPRO_*`` environment variable read in the
    source has a row in the README's environment-knob table.  The port
    reads none.
  * ``materialize-allowlist`` -- ``effective_weight`` /
    ``materialize_leaf`` are called only where a weight-sized
    materialization is the design.
"""
from __future__ import annotations

import ast
import pathlib

from repro_torch.analysis.report import Finding

_PKG = pathlib.Path(__file__).resolve().parents[1]      # .../repro_torch
REPO_ROOT = _PKG.parents[1]


def _rel(path) -> str:
    p = pathlib.Path(path).resolve()
    try:
        return p.relative_to(REPO_ROOT).as_posix()
    except ValueError:
        return p.as_posix()


def _parse(path):
    return ast.parse(pathlib.Path(path).read_text(), filename=str(path))


def _call_name(func) -> str:
    """Trailing name of a call target: torch.manual_seed -> manual_seed."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


# ---------------------------------------------------------------------------
# bare-seed
# ---------------------------------------------------------------------------

# (repo-relative file, constant) -> why a constant seed is right there
SEED_ALLOWLIST: dict = {}


def check_bare_seed(files, allowlist=SEED_ALLOWLIST) -> list:
    findings = []
    for path in files:
        rel = _rel(path)
        for node in ast.walk(_parse(path)):
            if not (isinstance(node, ast.Call)
                    and _call_name(node.func) == "manual_seed"
                    and node.args):
                continue
            a = node.args[0]
            if (isinstance(a, ast.Constant) and isinstance(a.value, int)
                    and (rel, a.value) not in allowlist):
                findings.append(Finding(
                    "bare-seed", f"{rel}:{node.lineno}",
                    f"manual_seed({a.value}) — derive the seed from the "
                    "run seed (--seed, or mask_stream_seed of it)"))
    return findings


def launch_files(pkg=_PKG):
    return sorted((pathlib.Path(pkg) / "launch").glob("*.py"))


# ---------------------------------------------------------------------------
# missing-oracle / missing-kernel-boundary
# ---------------------------------------------------------------------------


def _launched_kernel(fn) -> str:
    """The kernel name a function passes to ``build.launch``, or ""."""
    for sub in ast.walk(fn):
        if (isinstance(sub, ast.Call) and _call_name(sub.func) == "launch"
                and sub.args and isinstance(sub.args[0], ast.Constant)):
            return sub.args[0].value
    return ""


def _has_boundary(fn) -> bool:
    return any(isinstance(d, ast.Call) and _call_name(d.func)
               == "kernel_boundary" for d in fn.decorator_list)


def _string_tuple(tree, name: str) -> tuple:
    """The strings of a module-level ``name = ("a", "b", ...)``."""
    for node in tree.body:
        if (isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets)
                and isinstance(node.value, (ast.Tuple, ast.List))):
            return tuple(e.value for e in node.value.elts
                         if isinstance(e, ast.Constant))
    return ()


def check_kernel_oracles(wrapper_paths, ref_path, dispatch_path,
                         build_path, csrc_dir) -> list:
    findings = []
    ref_names = {n.name for n in _parse(ref_path).body
                 if isinstance(n, ast.FunctionDef)}
    kernels = set(_string_tuple(_parse(dispatch_path), "KERNELS"))
    for path in wrapper_paths:
        for fn in _parse(path).body:
            if not isinstance(fn, ast.FunctionDef) or fn.name.startswith("_"):
                continue
            kernel = _launched_kernel(fn)
            if not kernel:
                continue
            where = f"{_rel(path)}:{fn.name}"
            if fn.name not in ref_names:
                findings.append(Finding(
                    "missing-oracle", where,
                    f"kernel wrapper has no plain version in "
                    f"{_rel(ref_path)} (expected `{fn.name}`)"))
            if kernel not in kernels:
                findings.append(Finding(
                    "missing-oracle", where,
                    f"kernel `{kernel}` is not in dispatch.KERNELS, so no "
                    "launch of it is counted"))
            if not _has_boundary(fn):
                findings.append(Finding(
                    "missing-kernel-boundary", where,
                    "the wrapper does not run inside "
                    "dispatch.kernel_boundary: the op walker sees its "
                    "plain version's ops"))
    built = set(_string_tuple(_parse(build_path), "SOURCES"))
    for cu in sorted(pathlib.Path(csrc_dir).glob("*.cu")):
        if cu.stem not in built:
            findings.append(Finding(
                "missing-oracle", _rel(cu),
                f"CUDA source not in {_rel(build_path)}'s SOURCES: it is "
                "never built"))
    for name in sorted(built - {cu.stem for cu in
                                pathlib.Path(csrc_dir).glob("*.cu")}):
        findings.append(Finding(
            "missing-oracle", f"{_rel(build_path)}:{name}",
            "SOURCES names a kernel with no .cu source"))
    return findings


# ---------------------------------------------------------------------------
# knob-doc
# ---------------------------------------------------------------------------


def env_knob_reads(files) -> list:
    """[(knob, "file:line")] for every ``os.environ.get`` /
    ``os.getenv`` / ``os.environ[...]`` read of a ``REPRO_*`` name."""
    reads = []
    for path in files:
        rel = _rel(path)
        for node in ast.walk(_parse(path)):
            knob = None
            if isinstance(node, ast.Call) and node.args:
                name = _call_name(node.func)
                a = node.args[0]
                named = (isinstance(a, ast.Constant)
                         and isinstance(a.value, str)
                         and a.value.startswith("REPRO_"))
                if named and name == "getenv":
                    knob = a.value
                elif (named and name == "get"
                      and isinstance(node.func, ast.Attribute)):
                    v = node.func.value
                    if ((isinstance(v, ast.Attribute)
                         and v.attr == "environ")
                            or (isinstance(v, ast.Name)
                                and v.id == "environ")):
                        knob = a.value
            elif (isinstance(node, ast.Subscript)
                  and isinstance(node.ctx, ast.Load)
                  and isinstance(node.value, ast.Attribute)
                  and node.value.attr == "environ"
                  and isinstance(node.slice, ast.Constant)
                  and isinstance(node.slice.value, str)
                  and node.slice.value.startswith("REPRO_")):
                knob = node.slice.value
            if knob:
                reads.append((knob, f"{rel}:{node.lineno}"))
    return reads


def readme_knobs(readme_path) -> set:
    """``REPRO_*`` names with a row in the README's env-knob table."""
    import re
    row = re.compile(r"^\|\s*`(REPRO_[A-Z0-9_]+)`")
    out = set()
    for line in pathlib.Path(readme_path).read_text().splitlines():
        m = row.match(line.strip())
        if m:
            out.add(m.group(1))
    return out


def check_knob_docs(files, readme_path) -> list:
    documented = readme_knobs(readme_path)
    return [Finding(
        "knob-doc", where,
        f"`{knob}` is read here but has no row in the README "
        "env-knob table")
        for knob, where in env_knob_reads(files)
        if knob not in documented]


# ---------------------------------------------------------------------------
# materialize-allowlist
# ---------------------------------------------------------------------------

MATERIALIZE_CALLS = frozenset({"effective_weight", "materialize_leaf"})

# (repo-relative file, enclosing function, callee): the only places a
# weight-sized materialization is the design
MATERIALIZE_ALLOWLIST = frozenset({
    # the per-token decode residue: one (W, C) conv kernel a step
    ("src/repro_torch/models/layers.py", "conv1d_step", "effective_weight"),
    # the wrapper delegates to the core builder
    ("src/repro_torch/models/layers.py", "effective_weight",
     "materialize_leaf"),
    # the one-time materialization of a decode session's tree
    ("src/repro_torch/core/masking.py", "freeze_for_decode",
     "materialize_leaf"),
    # the materialized twin of the forward tree the tests compare with
    ("src/repro_torch/core/masking.py", "hash_effective",
     "materialize_leaf"),
    # the materializing path the op walker holds the fused step against
    ("src/repro_torch/analysis/model_check.py", "forward",
     "materialize_leaf"),
})


def check_materialize_allowlist(files,
                                allowlist=MATERIALIZE_ALLOWLIST) -> list:
    findings = []
    for path in files:
        rel = _rel(path)

        def visit(node, fname):
            for child in ast.iter_child_nodes(node):
                cf = fname
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    cf = child.name
                if isinstance(child, ast.Call):
                    callee = _call_name(child.func)
                    if (callee in MATERIALIZE_CALLS
                            and (rel, fname, callee) not in allowlist):
                        findings.append(Finding(
                            "materialize-allowlist",
                            f"{rel}:{child.lineno}",
                            f"`{callee}` called outside the allowlist "
                            f"(in `{fname or '<module>'}`): a "
                            "weight-sized materialization"))
                visit(child, cf)

        visit(_parse(path), "")
    return findings


# ---------------------------------------------------------------------------
# the repo's layout
# ---------------------------------------------------------------------------


def run_all(repo_root=REPO_ROOT) -> list:
    """Every rule over the repo: ``launch/`` for bare seeds, the kernel
    wrappers, plain versions, dispatch table and build list for oracles,
    ``src/repro_torch/`` and ``chip_smoke.py`` for knob reads,
    ``src/repro_torch/`` for materializing calls."""
    repo_root = pathlib.Path(repo_root)
    pkg = repo_root / "src" / "repro_torch"
    kern = pkg / "kernels"
    files = sorted(pkg.rglob("*.py"))
    findings = check_bare_seed(launch_files(pkg))
    findings += check_kernel_oracles(
        [kern / "masked_matmul.py", kern / "bitpack.py"], kern / "ref.py",
        kern / "dispatch.py", kern / "build.py", kern / "csrc")
    smoke = [p for p in [repo_root / "chip_smoke.py"] if p.exists()]
    findings += check_knob_docs(files + smoke, repo_root / "README.md")
    findings += check_materialize_allowlist(files)
    return findings
