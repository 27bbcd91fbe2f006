"""The port's data modules against the JAX package: the partitioners
(numpy draws, so the indices are equal), `make_image_task` from the
reference's own draws (threefry, injected) to f32 rounding of the
bilinear upsampling (1e-6 of the scale, edges included), and
`federated_batches` with the reference's picks injected, equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import partition as jpartition
from repro.data import synthetic as jsynthetic

from repro_torch.data import partition, synthetic
from test_torch_threads import torch_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("how", ["iid", "by_class", "dirichlet"])
@pytest.mark.parametrize("k", [3, 10])
def test_partitions_equal_jax(how, k):
    labels = np.random.default_rng(5).integers(0, 10, 997)
    call = {"iid": lambda m, r: m.partition_iid(r, labels, k),
            "by_class": lambda m, r: m.partition_by_class(r, labels, k, 2),
            "dirichlet": lambda m, r: m.partition_dirichlet(r, labels, k,
                                                            0.3)}[how]
    want = call(jpartition, np.random.default_rng(11))
    got = call(partition, np.random.default_rng(11))
    assert len(got) == len(want) == k
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _jax_draws(key, n, img, channels, n_classes, proto_scale):
    """The reference's draws, as `make_image_task` takes them."""
    kp, kn, kl = jax.random.split(key, 3)
    small = jax.random.normal(kp, (n_classes, 8, 8, channels)) * proto_scale
    labels = jax.random.randint(kl, (n,), 0, n_classes)
    normals = jax.random.normal(kn, (n, img, img, channels))
    return [torch.from_numpy(np.array(a)) for a in (small, labels,
                                                      normals)]


@pytest.mark.parametrize("img,channels,n_classes", [(8, 3, 4), (16, 1, 10),
                                                    (32, 3, 20)])
def test_image_task_matches_jax_on_its_draws(img, channels, n_classes):
    key = jax.random.PRNGKey(img + channels)
    want = jsynthetic.make_image_task(key, n=64, img=img, channels=channels,
                                      n_classes=n_classes, proto_scale=1.4,
                                      noise=0.45)
    got = synthetic.image_task_from_draws(
        *_jax_draws(key, 64, img, channels, n_classes, 1.4), noise=0.45)
    assert got.n_classes == want.n_classes
    assert np.array_equal(got.y.numpy(), np.asarray(want.y))
    wx = np.asarray(want.x)
    assert got.x.dtype == torch.float32 and got.x.shape == wx.shape
    np.testing.assert_allclose(got.x.numpy(), wx, rtol=0,
                               atol=1e-6 * np.abs(wx).max())


def test_make_image_task_draws_from_the_generator():
    gen = lambda: torch.Generator().manual_seed(3)
    a = synthetic.make_image_task(gen(), n=32, img=8, n_classes=4)
    b = synthetic.make_image_task(gen(), n=32, img=8, n_classes=4)
    assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
    assert a.x.shape == (32, 8, 8, 3) and int(a.y.max()) < 4


@pytest.mark.parametrize("per_client", [40, 7])   # with and w/o replacement
def test_federated_batches_match_jax_with_its_picks(per_client):
    K, H, B = 3, 2, 5
    rng = np.random.default_rng(2)
    task_np = (rng.standard_normal((200, 4, 4, 2)).astype(np.float32),
               rng.integers(0, 6, 200).astype(np.int32))
    cidx = [np.sort(rng.choice(200, per_client, replace=False))
            for _ in range(K)]
    jtask = jsynthetic.ImageTask(jnp.asarray(task_np[0]),
                                 jnp.asarray(task_np[1]), 6)
    key = jax.random.PRNGKey(9)
    want = jsynthetic.federated_batches(key, jtask, cidx, K, H, B)
    keys = jax.random.split(key, K)
    picks = [np.asarray(jax.random.choice(keys[i], c.shape[0], (H * B,),
                                          replace=c.shape[0] < H * B))
             for i, c in enumerate(cidx)]
    ttask = synthetic.ImageTask(torch.from_numpy(task_np[0]),
                                torch.from_numpy(task_np[1]).long(), 6)
    got = synthetic.federated_batches(None, ttask, cidx, K, H, B,
                                      picks=picks)
    assert np.array_equal(got["images"].numpy(), np.asarray(want["images"]))
    assert np.array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    # drawn from a generator: the same shapes, each client's own samples,
    # no repeats when the client holds enough
    drawn = synthetic.federated_batches(torch.Generator().manual_seed(0),
                                        ttask, cidx, K, H, B)
    assert drawn["images"].shape == (K, H, B, 4, 4, 2)
    for i in range(K):
        rows = drawn["images"][i].reshape(H * B, -1)
        own = ttask.x[torch.from_numpy(cidx[i])].reshape(len(cidx[i]), -1)
        hit = (rows[:, None] == own[None]).all(-1)
        assert bool(hit.any(1).all())
        if per_client >= H * B:
            assert int(hit.any(0).sum()) == H * B
