"""Rule-based aten-op walker guarding the mask-native invariants: the
port's twin of the reference's `repro.analysis.jaxpr_lint`.

A torch program has no jaxpr, so the walker (`OpWalker`) is a
`TorchDispatchMode`: it sees every aten op a step runs, forward and
backward, after autograd and before the kernels, and hands each op's
outputs to rules with the `check_eqn` / `check_call` shape of the
reference's `JaxprRule`.

The kernel boundary is the twin of the reference walker never entering a
``pallas_call``.  Every wrapper of `kernels.masked_matmul` and
`kernels.bitpack` runs its body inside `dispatch.kernel_boundary`: while
a walker is open, the ops of the body (the plain version's m * w on the
CPU, the output's allocation on the card) are hidden from it, and the
call is shown to `check_call` as one opaque op ``kernel:<name>`` with its
output shapes, on the CPU and on the card alike.

Rules:

  * `weight_f32_temporaries` -- weight-shaped f32 values outside the
    kernels (rule ``weight-f32-temporary``);
  * `mask_materialization` -- weight-shaped bool/uint8/int8 values: a
    mask made it into memory (``mask-materialization``);
  * `DtypePromotionRule` -- any f64 value, and a weight-shaped bf16 ->
    f32 ``_to_copy`` (``dtype-promotion``);
  * `InPlaceRule` -- the twin of the reference's ``DonationAliasRule``.
    Torch has no buffer donation; the port's design is the in-place
    update (`launch.steps`): every state leaf keeps its storage
    (``untyped_storage().data_ptr()``) through a train step and through
    a round (``in-place-reuse``).  It compares the state before and
    after, so it is not an op rule.

View ops (``view``, ``reshape``, ``squeeze``, ``as_strided``, ...) are
exempt from the shape rules, as the reference's ``_VIEW_PRIMS`` are:
they compute nothing and alias their operand.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.report import Finding
from repro_torch.core import tree as tu
from repro_torch.kernels import dispatch

# ops that compute nothing and alias their operand (aten names without
# the overload); any op the dispatcher marks as a view is exempt as well
_VIEW_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "squeeze",
    "unsqueeze", "as_strided", "expand", "permute", "transpose", "t",
    "select", "slice", "alias", "detach", "unbind", "split", "narrow",
    "view_as", "diagonal", "unfold", "lift_fresh"})


@dataclasses.dataclass(frozen=True)
class OpEvent:
    """One op the walker saw: `name` is the aten op without its overload
    (``mm``, ``_to_copy``) or ``kernel:<name>`` for a kernel call;
    `outputs` are the (shape, dtype) of its tensor results, `inputs` of
    its tensor operands (for ``_to_copy`` only, the one op a rule reads
    them of: reading every op's operands would double the walk)."""
    name: str
    outputs: tuple
    inputs: tuple = ()
    is_view: bool = False


def _specs(x) -> tuple:
    flat = x if isinstance(x, (list, tuple)) else (x,)
    out = []
    for t in flat:
        if isinstance(t, torch.Tensor):
            out.append((tuple(int(d) for d in t.shape), t.dtype))
        elif isinstance(t, (list, tuple)):
            out.extend(_specs(t))
    return tuple(out)


class OpRule:
    """One invariant over the ops a program runs.

    `check_eqn` sees every op outside the kernels; `check_call` sees each
    kernel call (``kernel:<name>``) as one op.  Both return iterables of
    `Finding`s."""

    name = "abstract"

    def check_eqn(self, ev: OpEvent):
        return ()

    def check_call(self, ev: OpEvent):
        return ()


class OpWalker(TorchDispatchMode):
    """Run `rules` over every aten op executed while the walker is open;
    `findings` collects what they report and `n_ops` / `n_kernels`
    count what was seen."""

    def __init__(self, rules: Sequence[OpRule]):
        super().__init__()
        self.rules = list(rules)
        self.findings: list = []
        self.n_ops = 0
        self.n_kernels = 0

    def __enter__(self):
        dispatch.WALKERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            dispatch.WALKERS.remove(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if dispatch.inside_kernel():
            return out
        self.n_ops += 1
        name = func.overloadpacket.__name__
        ev = OpEvent(name, _specs(out),
                     _specs(list(args)) if name == "_to_copy" else (),
                     bool(func.is_view))
        for r in self.rules:
            self.findings.extend(r.check_eqn(ev))
        return out

    def kernel(self, name: str, out) -> None:
        """Called by `dispatch.kernel_boundary` when a wrapper returns."""
        self.n_kernels += 1
        ev = OpEvent(f"kernel:{name}", _specs(out))
        for r in self.rules:
            self.findings.extend(r.check_call(ev))


def lint_ops(fn: Callable, args: Sequence, rules: Sequence[OpRule]) -> list:
    """Run `rules` over every op of `fn(*args)`."""
    with OpWalker(rules) as w:
        fn(*args)
    return w.findings


class ShapedDefRule(OpRule):
    """Flag ops defining a value of `shape` with a dtype in `dtypes`;
    view ops are exempt."""

    def __init__(self, name, shape, dtypes):
        self.name = name
        self._shape = tuple(int(d) for d in shape)
        self._dtypes = frozenset(dtypes)

    def check_eqn(self, ev):
        if ev.is_view or ev.name in _VIEW_OPS:
            return ()
        return [Finding(self.name, ev.name,
                        f"defines {str(dt).replace('torch.', '')}"
                        f"{list(shape)}")
                for shape, dt in ev.outputs
                if shape == self._shape and dt in self._dtypes]


def weight_f32_temporaries(weight_shape) -> ShapedDefRule:
    """Weight-shaped f32 values computed outside the kernels: the
    invariant behind the fused path's claim that no m * w or weight-sized
    f32 tensor ever exists in device memory."""
    return ShapedDefRule("weight-f32-temporary", weight_shape,
                         (torch.float32,))


def mask_materialization(weight_shape) -> ShapedDefRule:
    """Weight-shaped bool/uint8/int8 values: a materialized mask.  On the
    fused path a mask exists only inside a kernel's registers and shared
    memory."""
    return ShapedDefRule("mask-materialization", weight_shape,
                         (torch.bool, torch.uint8, torch.int8))


class DtypePromotionRule(OpRule):
    """Any f64 value (the numerics are f32/bf16 end to end), and a
    weight-shaped bf16 -> f32 ``_to_copy`` outside the kernels (a copy
    that doubles a weight's footprint).  With no `weight_shapes` only the
    f64 check applies."""

    name = "dtype-promotion"

    def __init__(self, weight_shapes=()):
        self._shapes = frozenset(tuple(s) for s in weight_shapes)

    def check_eqn(self, ev):
        out = []
        for shape, dt in ev.outputs:
            if dt == torch.float64:
                out.append(Finding(self.name, ev.name,
                                   f"f64 value of shape {list(shape)}"))
            elif (ev.name == "_to_copy" and shape in self._shapes
                  and dt == torch.float32 and ev.inputs
                  and ev.inputs[0][1] == torch.bfloat16):
                out.append(Finding(self.name, ev.name,
                                   f"weight-shaped bf16->f32 upcast "
                                   f"{list(shape)}"))
        return out


def _storages(state) -> dict:
    out = {}
    for key in sorted(k for k, v in state.items()
                      if isinstance(v, (dict, list, tuple))):
        for path, t in tu.flatten_with_paths(state[key], key):
            if isinstance(t, torch.Tensor):
                out[path] = t.untyped_storage().data_ptr()
    return out


class InPlaceRule:
    """Every tensor leaf of a state keeps its storage through a step: the
    steps update scores, moments and floats in place, so a leaf rebound
    to a new tensor is a full copy of the state that no one meant to
    make.  Take the snapshot before the step, `check` the state after."""

    name = "in-place-reuse"

    def __init__(self, state):
        self._before = _storages(state)

    def check(self, state) -> list:
        after = _storages(state)
        out = []
        for path, ptr in self._before.items():
            if after.get(path) != ptr:
                out.append(Finding(
                    self.name, path,
                    "the leaf left its storage (rebound to a new tensor)"
                    if path in after else "the leaf is gone"))
        return out


def count_weight_f32_defs(fn: Callable, args: Sequence, weight_shape) -> int:
    """Ops of `fn(*args)` defining an f32 value of `weight_shape` outside
    the kernels (view ops skipped; one count an output)."""
    return len(lint_ops(fn, args, [weight_f32_temporaries(weight_shape)]))
