"""The port stands alone: no module under src/repro_torch, and not
chip_smoke.py, imports JAX or the JAX package `repro`."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path}: imports {bad}"


def test_package_is_nonempty():
    assert len(FILES) > 20 and (ROOT / "chip_smoke.py").exists()


# the paper-CNN slice: its fourteen modules (optim, partition, synthetic,
# regularizer, masking, layers, cnn, convert, federated, payloads, codecs,
# protocol, algorithms with the registry, the Fig. 1 benchmark)
SLICE = ("repro_torch.optim.optimizers", "repro_torch.data.partition",
         "repro_torch.data.synthetic", "repro_torch.core.regularizer",
         "repro_torch.core.masking", "repro_torch.models.layers",
         "repro_torch.models.cnn", "repro_torch.convert",
         "repro_torch.core.federated", "repro_torch.api.payloads",
         "repro_torch.api.codecs", "repro_torch.api.protocol",
         "repro_torch.api.algorithms", "repro_torch.api.registry",
         "repro_torch.benchmarks.common", "repro_torch.benchmarks.fig1_iid",
         # the rest of the host-sim API: the baselines shim and the Fig. 2
         # benchmark (codecs, payloads, algorithms and aggregation above
         # now hold all of their reference modules)
         "repro_torch.core.aggregation", "repro_torch.core.baselines",
         "repro_torch.launch.train", "repro_torch.benchmarks.fig2_noniid",
         # checkpoint and restart, the runtime and the chaos tool
         "repro_torch.ckpt.checkpoint", "repro_torch.runtime.fault",
         "repro_torch.runtime.elastic", "repro_torch.runtime.async_engine",
         "repro_torch.runtime.agg_tree", "repro_torch.analysis.comm_model",
         "repro_torch.tools.chaos_smoke",
         # the rest of the LM zoo: the new configs, the encoder-decoder,
         # the VLM branch and the fedavg plan
         "repro_torch.configs.deepseek_7b", "repro_torch.configs.qwen2_7b",
         "repro_torch.configs.qwen2_vl_2b",
         "repro_torch.configs.whisper_medium",
         "repro_torch.configs.deepseek_v2_236b",
         "repro_torch.models.encdec", "repro_torch.models.transformer",
         "repro_torch.launch.plans", "repro_torch.launch.steps",
         "repro_torch.launch.serve",
         # multi-device: the mesh, the sharding rules, the mesh round's
         # torchrun entry point
         "repro_torch.launch.mesh", "repro_torch.launch.sharding",
         "repro_torch.launch.mesh_round")


def test_slice_modules_import_with_jax_and_repro_blocked():
    """Each module of the slice exists and imports in a fresh interpreter
    in which importing jax or repro raises."""
    import subprocess
    import sys
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {SLICE!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
            "               for k in sys.modules if sys.modules[k])\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for m in SLICE:
        assert (ROOT / "src" / (m.replace(".", "/") + ".py")).exists(), m
