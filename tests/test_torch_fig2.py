"""The port's Fig. 2 benchmark (`repro_torch.benchmarks.fig2_noniid`):
the CSV it prints against the reference benchmark's, its device default,
and a statistical check against the JAX package on the quickstart CNN
(Conv 8-8 / dense 32, 4 classes of 8x8 images) split non-IID, c = 2
classes a client over K = 4 clients, 2 local steps of batch 32.  The two
packages draw their data, masks and coins from different generators, so
they agree in distribution, not bit for bit.  Over 6 rounds on seeds 0
and 1: the fedpm_reg variants at lambda 0 and 1 (adam, lr 0.1, as
`run_fedpm_variant`) reach a mean accuracy over their last three rounds
within 0.2 of the reference's; mv_signsgd reports exactly 1 Bpp in both;
topk's uplink keeps 0.3 of the scores, its sparsity 0.7 within one
parameter's share in both."""
import io
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.models import cnn as jcnn

from repro_torch.benchmarks import common, fig2_noniid
from repro_torch.data import synthetic
from repro_torch.models import cnn
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from benchmarks import common as jcommon  # noqa: E402
from benchmarks import fig2_noniid as jfig2  # noqa: E402

QUICK = dict(name="quick", conv_planes=(8, 8), dense_sizes=(32,),
             n_classes=4, img_size=8)
K, C, H, ROUNDS, SEEDS = 4, 2, 2, 6, (0, 1)
ALGOS = (("lam=0.0", "fedpm_reg", dict(lam=0.0, lr=0.1, optimizer="adam",
                                       float_lr=1e-3)),
         ("lam=1.0", "fedpm_reg", dict(lam=1.0, lr=0.1, optimizer="adam",
                                       float_lr=1e-3)),
         ("topk", "topk", dict(k_frac=0.3)),
         ("mv_signsgd", "mv_signsgd", {}))


def _jax_runs():
    cfg = jcnn.ConvConfig(**QUICK)
    apply_fn = lambda p, b: jcnn.forward(p, cfg, b["images"])
    out = {}
    for name, algo_name, kw in ALGOS:
        algo = japi.get_algorithm(algo_name, apply_fn, jcnn.ce_loss,
                                  local_steps=H, **kw)
        evaluate = jax.jit(lambda st, test, k, algo=algo: japi.evaluate(
            algo, st, test, apply_fn, jcnn.accuracy, k, n_samples=2))
        for seed in SEEDS:
            key = jax.random.PRNGKey(seed)
            task = jsynthetic.make_image_task(key, n=512, img=8,
                                              n_classes=4, noise=0.35)
            cidx = jpartition.partition_by_class(
                np.random.default_rng(seed), np.asarray(task.y), K, C)
            st = algo.init(key, jcnn.init_params(key, cfg))
            sizes = jnp.asarray([len(c) for c in cidx], jnp.float32)
            test = {"images": task.x[:256], "labels": task.y[:256]}
            accs, ms = [], []
            for r in range(ROUNDS):
                kr = jax.random.fold_in(key, r)
                data = jsynthetic.federated_batches(kr, task, cidx, K, H, 32)
                st, m = algo.round(st, data, jnp.ones((K,), bool), sizes,
                                   kr)
                accs.append(float(evaluate(st, test, kr)))
                ms.append({k: float(v) for k, v in m.items()})
            out.setdefault(name, []).append((accs, ms))
    return out


def _port_runs():
    cfg = cnn.ConvConfig(**QUICK)
    out = {}
    for name, algo_name, kw in ALGOS:
        for seed in SEEDS:
            gen = torch.Generator().manual_seed(seed)
            task = synthetic.make_image_task(gen, n=512, img=8, n_classes=4,
                                             noise=0.35)
            setup = common.setup_from(cfg, task, K, C, seed, gen)
            setup["test"] = {"images": task.x[:256], "labels": task.y[:256]}
            ms = []
            hist, _ = common.run_algorithm(setup, algo_name, ROUNDS,
                                           local_steps=H, seed=seed, **kw)
            for r in range(ROUNDS):
                ms.append({"uplink_bpp": hist["bpp"][r],
                           "uplink_bpp_measured": hist["bpp_measured"][r],
                           "sparsity": hist["sparsity"][r]})
            out.setdefault(name, []).append((hist["acc"], ms))
    return out


def test_noniid_statistics_match_jax():
    runs = {"jax": _jax_runs(), "port": _port_runs()}
    acc = {pkg: {name: float(np.mean([np.mean(a[-3:]) for a, _ in rs]))
                 for name, rs in r.items()} for pkg, r in runs.items()}
    for name in ("lam=0.0", "lam=1.0"):
        assert abs(acc["port"][name] - acc["jax"][name]) <= 0.2, acc
    n = sum(int(np.prod(s)) for s in ((3, 3, 3, 8), (3, 3, 8, 8),
                                      (128, 32), (32, 4)))
    for pkg, r in runs.items():
        for _, ms in r["mv_signsgd"]:
            assert all(m["uplink_bpp"] == 1.0 for m in ms), pkg
        for _, ms in r["topk"]:
            assert all(abs(m["sparsity"] - 0.7) <= 1.0 / n + 1e-6
                       for m in ms), (pkg, [m["sparsity"] for m in ms])
        for name in ("lam=0.0", "lam=1.0"):
            for _, ms in r[name]:
                assert all(0.0 < m["uplink_bpp"] <= 1.0 for m in ms), pkg


def _reference_rows(monkeypatch, rounds):
    """The reference benchmark's CSV with its training stubbed out: the
    header and the (dataset, algo, round) order it prints."""
    hist = {"acc": [0.5] * rounds, "bpp": [1.0] * rounds,
            "bpp_measured": [1.0] * rounds,
            "cumulative_uplink_mb": [1.0] * rounds,
            "cumulative_downlink_mb": [1.0] * rounds,
            "ledger": {"cumulative_total_mb": 2.0}}
    monkeypatch.setattr(jcommon, "make_setup", lambda *a, **kw: {})
    monkeypatch.setattr(jcommon, "run_fedpm_variant",
                        lambda *a, **kw: (hist, None))
    monkeypatch.setattr(jcommon, "run_algorithm",
                        lambda *a, **kw: (hist, None))
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    jfig2.main(rounds=rounds, k=3, c=2)
    monkeypatch.undo()
    lines = out.getvalue().splitlines()
    return lines[0], [tuple(l.split(",")[:3]) for l in lines[1:]]


def _small_setup(dataset, k, c, seed=0, n=1024, device="cuda"):
    """`common.make_setup` on 256 images of the quickstart's task (4
    classes of 8x8) and a Conv 16-32 / dense 64 CNN: the grid's rows and
    fields do not depend on the widths."""
    assert dataset in fig2_noniid.DATASETS
    gen = torch.Generator(device).manual_seed(seed)
    task = synthetic.make_image_task(gen, n=256, img=8, n_classes=4,
                                     noise=0.35)
    cfg = cnn.ConvConfig("small", (16, 32), (64,), n_classes=4, img_size=8)
    return common.setup_from(cfg, task, k, c, seed, gen)


def test_fig2_benchmark_prints_the_reference_grid_on_cpu(monkeypatch):
    header, order = _reference_rows(monkeypatch, 1)
    monkeypatch.setattr(common, "make_setup", _small_setup)
    out, err = io.StringIO(), io.StringIO()
    res = fig2_noniid.main(rounds=1, k=3, c=2, device="cpu", out=out,
                           err=err)
    lines = out.getvalue().splitlines()
    assert lines[0] == header == fig2_noniid.HEADER
    rows = [l.split(",") for l in lines[1:]]
    assert [tuple(r[:3]) for r in rows] == order
    for r in rows:
        acc, bpp, bpp_m, up, down = map(float, r[3:])
        assert 0.0 <= acc <= 1.0 and 0.0 < bpp <= 1.0 + 1e-4
        assert bpp - 1e-4 <= bpp_m <= 1.1 and up > 0.0 and down > 0.0
        if r[1] == "mv_signsgd":
            assert bpp == 1.0
    assert sorted(res) == sorted(fig2_noniid.DATASETS)
    assert err.getvalue().count("final acc=") == len(order)


def test_fig2_benchmark_defaults_to_the_card():
    args = fig2_noniid.parse_args([])
    assert (args.device, args.rounds, args.k, args.c) == ("cuda", 12, 10, 2)
    if not torch.cuda.is_available():
        out = io.StringIO()
        with pytest.raises(RuntimeError, match="CUDA"):
            fig2_noniid.main(rounds=1, k=2, out=out)
        assert out.getvalue() == ""


def test_run_baseline_sweeps_a_built_algorithm():
    """`common.run_baseline` (the reference's legacy entry) drives an
    already-built algorithm: per-round accuracy, Bpp and loss, every
    client in every round."""
    cfg = cnn.ConvConfig(**QUICK)
    gen = torch.Generator().manual_seed(0)
    task = synthetic.make_image_task(gen, n=256, img=8, n_classes=4,
                                     noise=0.35)
    setup = common.setup_from(cfg, task, K, C, 0, gen)
    from repro_torch.core import baselines
    for algo, bpp in ((baselines.mv_signsgd(setup["apply_fn"],
                                            setup["loss_fn"],
                                            local_steps=H), 1.0),
                      (baselines.fedavg(setup["apply_fn"], setup["loss_fn"],
                                        local_steps=H), 32.0)):
        hist, st = common.run_baseline(setup, algo, 2, local_steps=H,
                                       batch=16)
        assert sorted(hist) == ["acc", "bpp", "loss"]
        assert hist["bpp"] == [bpp, bpp] and st.round == 2
        assert all(0.0 <= a <= 1.0 for a in hist["acc"])
        assert all(np.isfinite(hist["loss"]))
