"""The four examples of the port (`repro_torch.examples`), each run
through its `main(argv)` on the CPU at small arguments: the quickstart's
codec round trip exact, the serving example's artifact the size the JAX
package's `final_artifact` gives the same config (reckoned under
`jax.eval_shape`), `steps.make_serve_step` equal to `api.decode_step`
bit for bit, the LM trainer resuming from its checkpoint onto the run it
interrupted, the fault-tolerance demo's restore exact.  Every example
runs on the card by default and raises without one."""
import numpy as np
import pytest
import torch
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

from repro_torch.examples import (fault_tolerance_demo, quickstart,
                                  serve_masked, train_lm_masked)

EXAMPLES = {"quickstart": quickstart, "serve_masked": serve_masked,
            "train_lm_masked": train_lm_masked,
            "fault_tolerance_demo": fault_tolerance_demo}


def test_quickstart_codec_round_trip_is_exact(tmp_path, capsys):
    out = quickstart.main(["--device", "cpu", "--rounds", "1", "--out",
                           str(tmp_path / "art.npz")])
    assert out["exact"]
    text = capsys.readouterr().out
    assert "round 0: loss=" in text and "decode exact=True" in text
    assert out["artifact_bytes"] == (tmp_path / "art.npz").stat().st_size


def test_serve_masked_artifact_equals_the_reference(capsys):
    import jax

    from repro.configs.base import ArchConfig as JArchConfig
    from repro.core import federated as jfederated
    from repro.core import masking as jmasking
    from repro.models import build_model as jbuild

    out = serve_masked.main(["--device", "cpu", "--batch", "2",
                             "--prompt-len", "3", "--gen-tokens", "2"])
    cfg = serve_masked.CFG
    japi = jbuild(JArchConfig(**{f: getattr(cfg, f) for f in (
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab", "head_dim")}))

    def artifact(k):
        server = jfederated.init_server(k, japi.init_params(k),
                                        jmasking.MaskSpec())
        art = jfederated.final_artifact(server, k)
        return {p: w for p, (w, _) in art["masks"].items()}, server.theta

    words, theta = jax.eval_shape(artifact, jax.random.PRNGKey(0))
    assert out["masked_params"] == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(theta))
    assert out["packed_bytes"] == sum(
        int(np.prod(w.shape)) * 4 for w in words.values())
    text = capsys.readouterr().out
    assert "artifact: 3932160 masked params -> 491520 packed bytes" in text
    assert "decoded 2 tokens x 2 requests" in text
    assert out["tokens"].shape == (2,)


def test_serve_step_is_decode_step_bit_for_bit():
    from repro_torch.configs import get_config
    from repro_torch.core import tree as tu
    from repro_torch.launch import steps
    from repro_torch.models import build_model

    api = build_model(get_config("internlm2-1.8b", smoke=True))
    gen = torch.Generator().manual_seed(3)
    params = api.init_params(gen)
    toks = torch.randint(0, api.cfg.vocab, (2, 5), generator=gen)
    serve = steps.make_serve_step(api)
    c1, c2 = api.init_cache(2, 8, "cpu"), api.init_cache(2, 8, "cpu")
    for t in range(5):
        a, c1 = serve(params, c1, toks[:, t], t)
        b, c2 = api.decode_step(params, c2, toks[:, t], t)
        assert torch.equal(a, b)
    for x, y in zip(tu.leaves(c1), tu.leaves(c2)):
        assert torch.equal(x, y)


def test_train_lm_masked_resumes_from_its_checkpoint(tmp_path, capsys):
    argv = ["--device", "cpu", "--smoke", "--round-every", "1", "--batch",
            "1", "--seq", "16"]
    whole = train_lm_masked.main(argv + ["--steps", "3", "--ckpt-dir",
                                         str(tmp_path / "a")])
    train_lm_masked.main(argv + ["--steps", "2", "--ckpt-dir",
                                 str(tmp_path / "b")])
    resumed = train_lm_masked.main(argv + ["--steps", "3", "--resume",
                                           "--ckpt-dir", str(tmp_path / "b")])
    text = capsys.readouterr().out
    assert "resumed from step 2" in text
    assert resumed["start"] == 2 and len(resumed["losses"]) == 1
    # the resumed step sees the batch and state the uninterrupted run's
    # third step saw
    assert resumed["losses"][0] == whole["losses"][2]
    assert resumed["rounds"][0] == whole["rounds"][2]
    assert 0.0 < whole["rounds"][0]["bpp"] <= 1.0


def test_fault_tolerance_demo_survives_its_restore(tmp_path, capsys):
    out = fault_tolerance_demo.main(["--device", "cpu", "--rounds", "6",
                                     "--ckpt-dir", str(tmp_path)])
    assert out["restored_equal"] is True
    assert len(out["accs"]) == 6
    assert all(0.0 <= a <= 1.0 for a in out["accs"])
    assert all(1 <= k <= 8 for k in out["alive"])
    text = capsys.readouterr().out
    assert "checkpoint saved; simulating coordinator crash" in text
    assert "survived 6 rounds with failures" in text


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_examples_run_on_the_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EXAMPLES[name].main([])
