"""The port's static-analysis command line
(`python -m repro_torch.tools.repro_lint`) on the CPU: every engine is
clean on the tree, the collective and shard engines on 8 spawned gloo
ranks; the tools' convention (``FAIL`` lines, a last ``# repro_lint:``
line, exit 0 only when ok); no card, no run on the card."""
import pytest
import torch

from repro_torch.tools import repro_lint
from test_torch_threads import torch_threads  # noqa: F401 (autouse)


def _last_line(capsys):
    return capsys.readouterr().out.strip().splitlines()[-1]


def test_local_engines_clean(capsys):
    assert repro_lint.main(["--device", "cpu", "--engines",
                            "source,stream,ops", "--archs",
                            "internlm2-1.8b,deepseek-v2-lite-16b"]) == 0
    assert _last_line(capsys) == "# repro_lint: ok"


def test_rank_engines_clean(capsys):
    """The collective engine's rounds (every mask algorithm and the
    unpacked liveness check) and the shard engine on 8 gloo ranks."""
    assert repro_lint.main(["--device", "cpu", "--engines",
                            "collective,shard", "--archs",
                            "internlm2-1.8b"]) == 0
    out = capsys.readouterr().out
    assert "internlm2-1.8b|fedpm_reg|unpacked: 13 sites, bpp_wire=16.0, " \
           "7 finding(s)" in out
    assert out.strip().splitlines()[-1] == "# repro_lint: ok"


def test_failures_are_reported(capsys):
    assert repro_lint.finish("repro_lint", ["x", "y"]) == 1
    assert capsys.readouterr().out.splitlines() == [
        "FAIL x", "FAIL y", "# repro_lint: 2 failure(s)"]
    assert repro_lint.main(["--device", "cpu", "--engines", "nope"]) == 2


def test_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_lint.main(["--engines", "source"])
