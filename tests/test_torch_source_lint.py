"""The port's AST source lint (`repro_torch.analysis.source_lint`): each
rule fires on a fixture written here and is clean on
``src/repro_torch/`` as it stands."""
import textwrap

from repro_torch.analysis import source_lint
from test_torch_threads import torch_threads  # noqa: F401 (autouse)


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(text))
    return p


def test_clean_on_the_tree():
    assert source_lint.run_all() == []


def test_bare_seed_fires(tmp_path):
    p = _write(tmp_path, "launch/bad.py", """
        import torch
        g = torch.Generator().manual_seed(29)
        torch.manual_seed(0)
        ok = torch.Generator().manual_seed(args.seed)
        """)
    found = source_lint.check_bare_seed([p])
    assert [f.rule for f in found] == ["bare-seed"] * 2
    assert [f.where.rsplit(":", 1)[1] for f in found] == ["3", "4"]
    assert source_lint.check_bare_seed(
        [p], {(source_lint._rel(p), 29): "why", (source_lint._rel(p), 0):
              "why"}) == []


def _kernel_tree(tmp_path, *, ref_names, kernels, sources, cu, boundary):
    deco = '@dispatch.kernel_boundary("k_fwd")\n' if boundary else ""
    wrappers = _write(tmp_path, "kernels/masked_matmul.py",
                      f'{deco}def k(x):\n'
                      '    build.launch("k_fwd", x)\n'
                      '    dispatch.LAUNCHES["k_fwd"] += 1\n\n'
                      'def _helper(x):\n    build.launch("hidden", x)\n')
    ref = _write(tmp_path, "kernels/ref.py",
                 "".join(f"def {n}(x):\n    return x\n" for n in ref_names))
    disp = _write(tmp_path, "kernels/dispatch.py",
                  f"KERNELS = {tuple(kernels)!r}\n")
    build = _write(tmp_path, "kernels/build.py",
                   f"SOURCES = {tuple(sources)!r}\n")
    for name in cu:
        _write(tmp_path, f"kernels/csrc/{name}.cu", "// kernel\n")
    return source_lint.check_kernel_oracles(
        [wrappers], ref, disp, build, tmp_path / "kernels" / "csrc")


def test_missing_oracle_fires(tmp_path):
    ok = dict(ref_names=["k"], kernels=["k_fwd"], sources=["k_fwd"],
              cu=["k_fwd"], boundary=True)
    assert _kernel_tree(tmp_path / "ok", **ok) == []
    for change, rule, count in (
            ({"ref_names": []}, "missing-oracle", 1),
            ({"kernels": []}, "missing-oracle", 1),
            ({"cu": ["k_fwd", "k_new"]}, "missing-oracle", 1),
            ({"sources": ["k_fwd", "k_gone"]}, "missing-oracle", 1),
            ({"boundary": False}, "missing-kernel-boundary", 1)):
        found = _kernel_tree(tmp_path / rule / str(len(change)) /
                             next(iter(change)), **{**ok, **change})
        assert [f.rule for f in found] == [rule] * count, (change, found)


def test_knob_doc_fires(tmp_path):
    p = _write(tmp_path, "src/x.py", """
        import os
        a = os.environ.get("REPRO_NEW")
        b = os.getenv("REPRO_DOCUMENTED")
        c = os.environ["REPRO_OTHER"]
        """)
    readme = _write(tmp_path, "README.md", """
        | knob | default | meaning |
        |---|---|---|
        | `REPRO_DOCUMENTED` | unset | documented |
        """)
    found = source_lint.check_knob_docs([p], readme)
    assert sorted(f.detail.split("`")[1] for f in found) == [
        "REPRO_NEW", "REPRO_OTHER"]
    assert {f.rule for f in found} == {"knob-doc"}


def test_materialize_allowlist_fires(tmp_path):
    p = _write(tmp_path, "models/new.py", """
        from repro_torch.core import masking

        def forward(p, x):
            return x @ masking.materialize_leaf(p)

        def decode(p):
            return effective_weight(p)
        """)
    found = source_lint.check_materialize_allowlist([p])
    assert [f.rule for f in found] == ["materialize-allowlist"] * 2
    rel = source_lint._rel(p)
    assert source_lint.check_materialize_allowlist([p], {
        (rel, "forward", "materialize_leaf"),
        (rel, "decode", "effective_weight")}) == []
