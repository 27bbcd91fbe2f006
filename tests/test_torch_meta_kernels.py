"""The kernel wrappers' shape-only path on the meta device (the twin of
`jax.eval_shape` through a ``pallas_call``): on meta tensors every
wrapper returns empty meta tensors of its plain version's output shapes
and types, launches nothing and states its work (`dispatch.count_work`);
meta mixed with CPU tensors raises.  A `FlopCounterMode` open over a
SMOKE dense train step on meta counts the kernels' stated flops beside
the aten matmuls, and the total equals the count reckoned from the
config: forward, dx and ds of every masked projection, the attention's
two batched products with their backward, and the f32 unembed with its
two backward products (the unembed is a float leaf: its weight has a
gradient)."""
import pytest
import torch
from test_torch_threads import torch_threads  # noqa: F401 (autouse)

from repro_torch.kernels import bitpack, dispatch
from repro_torch.kernels import masked_matmul as mm

E, M, K, N = 3, 5, 40, 24          # ragged: no dimension a multiple of 32
B, S, CH, W = 2, 7, 12, 4
R, NB = 3, 1000


def _calls():
    """Each wrapper as (call, operands): operands drawn on the CPU from a
    seeded generator, the call taking them in order."""
    g = torch.Generator().manual_seed(5)

    def t(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)

    bf = torch.bfloat16
    bits = (torch.rand(R, NB, generator=g) < 0.5).to(torch.uint8)
    return {
        "masked_matmul_fwd": (lambda x, w, s: mm.masked_matmul(
            x, w, s, 3, 5), [t(M, K, dtype=bf), t(K, N, dtype=bf),
                             t(K, N)]),
        "masked_matmul_dx": (lambda g_, w, s: mm.masked_matmul_dx(
            g_, w, s, 3, 5), [t(M, N, dtype=bf), t(K, N, dtype=bf),
                              t(K, N)]),
        "masked_matmul_ds": (mm.masked_matmul_ds, [
            t(M, K, dtype=bf), t(M, N, dtype=bf), t(K, N, dtype=bf),
            t(K, N)]),
        "sample_and_pack": (lambda s: mm.sample_and_pack(s, [11, 12]),
                            [t(2, NB)]),
        "masked_matmul_grouped": (lambda x, w, s: mm.masked_matmul_grouped(
            x, w, s, [1, 2, 3], [0, 7, 9]), [
            t(E, M, K), t(E, K, N, dtype=bf), t(E, K, N)]),
        "masked_matmul_grouped_dx": (
            lambda g_, w, s: mm.masked_matmul_grouped_dx(
                g_, w, s, [1, 2, 3], [0, 7, 9]),
            [t(E, M, N), t(E, K, N, dtype=bf), t(E, K, N)]),
        "masked_matmul_grouped_ds": (mm.masked_matmul_grouped_ds, [
            t(E, M, K), t(E, M, N), t(E, K, N, dtype=bf), t(E, K, N)]),
        "masked_conv1d": (lambda x, w, s: mm.masked_conv1d(x, w, s, 4, 8), [
            t(B, S, CH, dtype=bf), t(W, CH, dtype=bf), t(W, CH)]),
        "masked_conv1d_ds": (mm.masked_conv1d_ds, [
            t(B, S, CH, dtype=bf), t(B, S, CH), t(W, CH, dtype=bf),
            t(W, CH)]),
        "pack_bits": (bitpack.pack_bits, [bits]),
        "unpack_bits": (lambda w: bitpack.unpack_bits(w, NB),
                        [bitpack.pack_bits_plain(bits)]),
    }


# each kernel's stated flops at these shapes (masked_matmul.py's
# docstring); its bytes are its operands read once and its output
# written once
FLOPS = {
    "masked_matmul_fwd": 2 * M * K * N,
    "masked_matmul_dx": 2 * M * K * N,
    "masked_matmul_ds": 2 * M * K * N + mm.EPILOGUE_FLOPS * K * N,
    "sample_and_pack": 0,
    "masked_matmul_grouped": 2 * E * M * K * N,
    "masked_matmul_grouped_dx": 2 * E * M * K * N,
    "masked_matmul_grouped_ds": 2 * E * M * K * N
    + mm.EPILOGUE_FLOPS * E * K * N,
    "masked_conv1d": 2 * W * B * S * CH,
    "masked_conv1d_ds": 2 * W * B * S * CH + mm.EPILOGUE_FLOPS * W * CH,
    "pack_bits": 0,
    "unpack_bits": 0,
}


@pytest.mark.parametrize("name", dispatch.KERNELS)
def test_meta_call_gives_the_plain_shapes_and_launches_nothing(name):
    fn, ops = _calls()[name]
    want = fn(*ops)                               # the plain version
    dispatch.reset_launch_counts()
    with dispatch.work_counter() as work:
        got = fn(*[x.to("meta") for x in ops])
    assert got.device.type == "meta"
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == want.dtype
    assert not any(dispatch.LAUNCHES.values())
    assert list(work) == [name] and work[name]["calls"] == 1
    assert work[name]["flops"] == FLOPS[name]
    assert work[name]["bytes"] == sum(
        x.numel() * x.element_size() for x in ops) + \
        got.numel() * got.element_size()


MULTI = [k for k in dispatch.KERNELS if len(_calls()[k][1]) > 1]


@pytest.mark.parametrize("name", MULTI)
def test_meta_mixed_with_cpu_raises(name):
    """The last operand left on the CPU, the rest meta: the wrapper
    raises rather than pick a path."""
    fn, ops = _calls()[name]
    mixed = [x.to("meta") for x in ops[:-1]] + [ops[-1]]
    with pytest.raises(ValueError, match="operands must all lie"):
        fn(*mixed)


def test_smoke_dense_step_flops_equal_the_config_count():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis import stream_cover
    from repro_torch.configs import get_config
    from repro_torch.launch import steps

    cfg = get_config("internlm2-1.8b", smoke=True)
    C, Bc, Sq = 2, 2, 16
    api, state = stream_cover.meta_fed_state(cfg, C)
    batch = {"tokens": torch.empty((C, Bc, Sq), dtype=torch.int32,
                                   device="meta")}
    step = steps.make_train_step(api, steps.StepConfig())
    dispatch.reset_launch_counts()
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    assert not any(dispatch.LAUNCHES.values())

    d, L, V, hd = cfg.d_model, cfg.n_layers, cfg.vocab, cfg.hd
    H, Hkv, F = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    Mt = Bc * Sq                                  # tokens a cohort
    kn = (d * H * hd + 2 * d * Hkv * hd + H * hd * d   # q, k, v, o
          + 2 * d * F + F * d)                         # gate, up, down
    proj = C * L * 2 * Mt * kn
    want = {
        "masked_matmul_fwd": proj,
        "masked_matmul_dx": proj,
        "masked_matmul_ds": proj + C * L * mm.EPILOGUE_FLOPS * kn,
        # QK^T and PV (2 B H S^2 hd each), backward twice the forward
        "bmm": C * L * 3 * 2 * (2 * Bc * H * Sq * Sq * hd),
        # the f32 unembed, its dx and its weight's gradient
        "mm": C * 3 * (2 * Mt * d * V),
    }
    got = {str(k).split(".")[-1]: v
           for k, v in fc.get_flop_counts()["Global"].items()}
    assert got == want
    assert fc.get_total_flops() == sum(want.values())
