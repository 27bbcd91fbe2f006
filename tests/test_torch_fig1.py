"""The port's Fig. 1 benchmark (`repro_torch.benchmarks`): the CSV it
prints, its device default, and a statistical check against the JAX
package on the quickstart setup (`examples/quickstart.py`: the CNN
Conv 8-8 / dense 32 on 4 classes of 8x8 images, K = 4 clients, 2 local
steps of batch 32, fedpm_reg at lam 1 with adam at lr 0.1).  The two
packages draw their data and masks from different generators, so they
agree in distribution, not bit for bit: over 8 rounds on seeds 0-3 the
mean accuracy of the last three rounds must clear chance (0.25) by 0.1
in both, and the two means lie within 0.2 of each other; the final Bpp
(eq. 13) lies in [0.99, 1] for every run and the two packages' means
within 0.003 (measured: accuracy 0.54 and 0.53, Bpp 0.997 and 0.998)."""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro.models import cnn as jcnn

from repro_torch.benchmarks import common, fig1_iid
from repro_torch.data import synthetic
from repro_torch.models import cnn
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

HEADER = "dataset,algo,round,acc,bpp,bpp_measured,sparsity,cum_mb"
QUICK = dict(name="quick", conv_planes=(8, 8), dense_sizes=(32,),
             n_classes=4, img_size=8)
ALGO = dict(lam=1.0, local_steps=2, lr=0.1, optimizer="adam",
            float_lr=1e-3)
K, ROUNDS, SEEDS = 4, 8, (0, 1, 2, 3)


def _jax_runs():
    cfg = jcnn.ConvConfig(**QUICK)
    apply_fn = lambda p, b: jcnn.forward(p, cfg, b["images"])
    algo = japi.get_algorithm("fedpm_reg", apply_fn, jcnn.ce_loss, **ALGO)
    evaluate = jax.jit(lambda st, test, k: japi.evaluate(
        algo, st, test, apply_fn, jcnn.accuracy, k, n_samples=2))
    out = []
    for seed in SEEDS:   # as examples/quickstart.py runs it
        key = jax.random.PRNGKey(seed)
        task = jsynthetic.make_image_task(key, n=512, img=8, n_classes=4,
                                          noise=0.35)
        cidx = jpartition.partition_iid(np.random.default_rng(seed),
                                        np.asarray(task.y), K)
        st = algo.init(key, jcnn.init_params(key, cfg))
        sizes = jnp.asarray([len(c) for c in cidx], jnp.float32)
        test = {"images": task.x[:256], "labels": task.y[:256]}
        accs = []
        for r in range(ROUNDS):
            kr = jax.random.fold_in(key, r)
            data = jsynthetic.federated_batches(kr, task, cidx, K, 2, 32)
            st, m = algo.round(st, data, jnp.ones((K,), bool), sizes, kr)
            accs.append(float(evaluate(st, test, kr)))
        out.append((accs, float(m["uplink_bpp"])))
    return out


def _port_runs():
    cfg = cnn.ConvConfig(**QUICK)
    out = []
    for seed in SEEDS:
        gen = torch.Generator().manual_seed(seed)
        task = synthetic.make_image_task(gen, n=512, img=8, n_classes=4,
                                         noise=0.35)
        setup = common.setup_from(cfg, task, K, None, seed, gen)
        setup["test"] = {"images": task.x[:256], "labels": task.y[:256]}
        hist, _ = common.run_algorithm(setup, "fedpm_reg", ROUNDS, batch=32,
                                       seed=seed, **ALGO)
        out.append((hist["acc"], hist["bpp"][-1]))
    return out


def test_quickstart_statistics_match_jax():
    stats = {}
    for name, runs in (("jax", _jax_runs()), ("port", _port_runs())):
        acc = float(np.mean([np.mean(a[-3:]) for a, _ in runs]))
        bpps = [b for _, b in runs]
        assert all(0.99 <= b <= 1.0 for b in bpps), (name, bpps)
        assert acc >= 0.35, (name, acc)
        stats[name] = (acc, float(np.mean(bpps)))
    assert abs(stats["port"][0] - stats["jax"][0]) <= 0.2, stats
    assert abs(stats["port"][1] - stats["jax"][1]) <= 0.003, stats


def _small_setup(dataset, k, c, seed=0, n=1024, device="cuda"):
    """`common.make_setup` on 256 images of the quickstart's task (4
    classes of 8x8) and a Conv 16-32 / dense 64 CNN (~40k masked weights,
    so that the arithmetic coder's few bits a leaf stay under the 0.01
    Bpp the grid allows above eq. 13): the grid's rows and fields do not
    depend on the widths."""
    assert dataset in fig1_iid.DATASETS
    gen = torch.Generator(device).manual_seed(seed)
    task = synthetic.make_image_task(gen, n=256, img=8, n_classes=4,
                                     noise=0.35)
    cfg = cnn.ConvConfig("small", (16, 32), (64,), n_classes=4, img_size=8)
    return common.setup_from(cfg, task, k, c, seed, gen)


def test_fig1_benchmark_prints_the_grid_on_cpu(monkeypatch):
    monkeypatch.setattr(common, "make_setup", _small_setup)
    out, err = io.StringIO(), io.StringIO()
    gains = fig1_iid.main(rounds=1, k=3, device="cpu", out=out, err=err)
    lines = out.getvalue().splitlines()
    assert lines[0] == HEADER
    rows = [l.split(",") for l in lines[1:]]
    assert [(r[0], r[1], r[2]) for r in rows] == [
        (ds, v, "0") for ds in fig1_iid.DATASETS
        for v in ("fedpm", "fedpm+reg", "fedpm+reg4")]
    for r in rows:
        acc, bpp, bpp_m, sp, cum = map(float, r[3:])
        assert 0.0 <= acc <= 1.0 and 0.0 < bpp <= 1.0 and 0.0 <= sp <= 1.0
        assert bpp <= bpp_m <= bpp + 0.01 and cum > 0.0
    assert sorted(gains) == sorted(fig1_iid.DATASETS)
    assert "# summary" in err.getvalue()


def test_fig1_benchmark_defaults_to_the_card():
    args = fig1_iid.parse_args([])
    assert args.device == "cuda" and args.rounds == 12 and args.k == 10
    if not torch.cuda.is_available():
        out = io.StringIO()
        with pytest.raises(RuntimeError, match="CUDA"):
            fig1_iid.main(rounds=1, k=2, out=out)
        assert out.getvalue() == ""
        with pytest.raises(RuntimeError, match="CUDA"):
            common.make_setup("mnist-like", k=2, c=None)
