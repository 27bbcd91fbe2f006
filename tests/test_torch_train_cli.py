"""The port's launcher end to end on the CPU at SMOKE size, and its
refusal to fall back when a card is asked for and absent."""
import re

import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.launch import train
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

ROUND = re.compile(r"step (\d+): loss=([\d.]+) uplink=([\d.]+)Bpp "
                   r"\(wire ([\d.]+)Bpp (\w+)\) cum=([\d.]+)MB")


@pytest.mark.parametrize("algo,codec", [("fedpm_reg", "arithmetic"),
                                        ("fedmask", "bitpack"),
                                        ("fedpm_reg", "golomb")])
def test_cli_prints_round_lines_on_cpu(capsys, algo, codec):
    dispatch.reset_launch_counts()
    out = train.main(["--smoke", "--device", "cpu", "--algo", algo,
                      "--codec", codec, "--steps", "4", "--round-every",
                      "2", "--cohorts", "2", "--batch", "2", "--seq", "16"])
    lines = [ROUND.match(l) for l in capsys.readouterr().out.splitlines()]
    rounds = [m for m in lines if m]
    assert [int(m.group(1)) for m in rounds] == [2, 4]
    for m in rounds:
        assert 0.0 < float(m.group(3)) <= 1.0
        assert m.group(5) == codec
    assert len(out["losses"]) == 4 and len(out["rounds"]) == 2
    assert all(0.0 < r["bpp"] <= 1.0 for r in out["rounds"])
    # CPU tensors take the plain versions: no kernel launches
    assert not any(dispatch.LAUNCHES.values())


def test_cli_trains_the_moe_family_on_cpu(capsys):
    """deepseek-v2-lite SMOKE (MLA, routed and shared experts) through
    the launcher: round lines with uplink Bpp in (0, 1], finite losses,
    no kernel launches on the CPU."""
    dispatch.reset_launch_counts()
    out = train.main(["--arch", "deepseek-v2-lite-16b", "--smoke",
                      "--device", "cpu", "--steps", "4", "--round-every",
                      "2", "--cohorts", "2", "--batch", "2", "--seq", "16"])
    rounds = [m for m in map(ROUND.match, capsys.readouterr().out
                             .splitlines()) if m]
    assert [int(m.group(1)) for m in rounds] == [2, 4]
    assert all(0.0 < float(m.group(3)) <= 1.0 for m in rounds)
    assert len(out["losses"]) == 4 and all(
        0.0 < v < 20.0 for v in out["losses"])
    assert not any(dispatch.LAUNCHES.values())


@pytest.mark.parametrize("arch,extra", [
    ("mamba2-370m", []), ("recurrentgemma-9b", ["--seq", "16"])])
def test_cli_trains_the_recurrent_families_on_cpu(capsys, arch, extra):
    """mamba2 SMOKE (SSD, masked depthwise conv) and recurrentgemma SMOKE
    (RG-LRU, windowed MQA, a stacked rec tail) through the launcher:
    round lines with uplink Bpp in (0, 1], finite losses, no kernel
    launches on the CPU."""
    dispatch.reset_launch_counts()
    out = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", "4", "--round-every", "2", "--cohorts",
                      "2", "--batch", "2"] + extra)
    rounds = [m for m in map(ROUND.match, capsys.readouterr().out
                             .splitlines()) if m]
    assert [int(m.group(1)) for m in rounds] == [2, 4]
    assert all(0.0 < float(m.group(3)) <= 1.0 for m in rounds)
    assert len(out["losses"]) == 4 and all(
        0.0 < v < 20.0 for v in out["losses"])
    assert not any(dispatch.LAUNCHES.values())


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-2b"])
def test_cli_trains_the_encdec_and_vlm_families_on_cpu(capsys, arch):
    """whisper SMOKE (encoder-decoder, layer norms, zero frames) and
    qwen2-vl SMOKE (qkv bias; the launcher's batches carry tokens only)
    through the launcher: round lines with uplink Bpp in (0, 1], finite
    losses, no kernel launches on the CPU."""
    dispatch.reset_launch_counts()
    out = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", "4", "--round-every", "2", "--cohorts",
                      "2", "--batch", "2", "--seq", "16"])
    rounds = [m for m in map(ROUND.match, capsys.readouterr().out
                             .splitlines()) if m]
    assert [int(m.group(1)) for m in rounds] == [2, 4]
    assert all(0.0 < float(m.group(3)) <= 1.0 for m in rounds)
    assert len(out["losses"]) == 4 and all(
        0.0 < v < 20.0 for v in out["losses"])
    assert not any(dispatch.LAUNCHES.values())


def test_cli_raises_on_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1", "--device", "cuda"])
