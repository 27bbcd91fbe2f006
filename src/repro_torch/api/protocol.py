"""The `FedAlgorithm` protocol and the shared round engine
(`repro.api.protocol`).

Every federated algorithm is four functions and a payload spec:

    init(generator, params_like)               -> state
    client_update(state, data, generator, u)   -> (UplinkPayload, metrics)
    aggregate(state, payloads, wn, participation) -> state
    eval_params(state, generator, u)           -> effective model params

`client_update` is written for one client; `run_round` runs it for each
of the K clients in turn (one shared generator, drawn from in client
order), stacks their payloads, weights the client metrics by
|D_i| x participation (eq. 8 with dropped clients renormalized out) and
does all communication accounting in the transport layer:

  * the server broadcast goes through the algorithm's `downlink`
    (`ProbBroadcast` quantizes theta to k bits on the wire; clients see
    the dequantized copy), reported as `downlink_bpp` / `downlink_bits`;
  * every uplink payload is metered by the round's codec
    (`api.codecs`): `uplink_bpp` is the eq. 13 entropy bound,
    `uplink_bpp_measured` / `uplink_bits_measured` what the codec puts on
    the wire.

Where the reference draws from jax keys, a round here draws from one
`torch.Generator`: the downlink's uniforms first, then each client's.
`uniforms` injects them instead: {"downlink": [...], "clients": [one
client_update `u` per client]}.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import torch

from repro_torch.api import codecs as codecs_lib
from repro_torch.api import payloads as plds
from repro_torch.core import tree as tu

Pytree = Any


@dataclasses.dataclass(frozen=True)
class PayloadSpec:
    """Static description of what an algorithm's clients transmit."""
    cls: type                      # UplinkPayload class
    nominal_bpp: Optional[float]   # None: data-dependent (entropy-coded)
    description: str = ""
    default_codec: Optional[str] = None   # an `api.codecs` name


@runtime_checkable
class SupportsFedAlgorithm(Protocol):
    """Anything with these attributes plugs into `run_round`."""
    name: str
    payload_spec: PayloadSpec

    def init(self, generator, params_like): ...
    def client_update(self, state, data, generator, u=None): ...
    def aggregate(self, state, payloads, wn, participation): ...
    def eval_params(self, state, generator, u=None): ...


def client_view(algo, state, generator=None, u=None):
    """What the clients receive this round: (downlink payload or None, the
    state after the broadcast went over the (maybe quantized) wire)."""
    downlink = getattr(algo, "downlink", None)
    if downlink is None:
        return None, state
    return downlink(state, generator, u)


def client_phase(algo, state, data, n_clients: int, generator=None,
                 uniforms: Optional[dict] = None):
    """The round's client side: the downlink first, then each of the
    `n_clients` clients' `client_update` in turn, all drawing from
    `generator` (or the injected `uniforms`).  Returns (downlink payload
    or None, [payload], [metrics])."""
    uniforms = uniforms or {}
    # downlink: server -> clients over the broadcast wire
    dl_payload, client_state = client_view(algo, state, generator,
                                           uniforms.get("downlink"))
    client_u = uniforms.get("clients")
    payloads, metrics = [], []
    for k in range(n_clients):
        p, m = algo.client_update(
            client_state, tu.tree_map(lambda v: v[k], data), generator,
            None if client_u is None else client_u[k])
        payloads.append(p)
        metrics.append(m)
    return dl_payload, payloads, metrics


def run_round(algo, state, data, participation, sizes, generator=None,
              codec=None, uniforms: Optional[dict] = None):
    """One federated round, algorithm-agnostic.

    data: tree of tensors with leading axes (K, H, ...) (client, local
    step); participation: bool (K,); sizes: f32 (K,) (|D_i|).  Returns
    (new state, metrics of 0-d f32 tensors)."""
    if codec is None:
        codec = getattr(algo, "codec", None)
    n_clients = participation.shape[0]
    pf = participation.float()
    n_part = pf.sum()
    dl_payload, payloads, metrics = client_phase(
        algo, state, data, n_clients, generator, uniforms)

    w = sizes.float() * pf
    wn = w / torch.clamp(w.sum(), min=1e-9)
    new_state = algo.aggregate(state, plds.stack_payloads(payloads), wn,
                               participation)

    col = lambda vals: torch.stack([torch.as_tensor(
        v, dtype=torch.float32, device=wn.device) for v in vals])
    out = {k: (col([m[k] for m in metrics]) * wn).sum() for k in metrics[0]}
    # transport-layer accounting: one formula for every algorithm
    out["uplink_bpp"] = (col([p.bpp() for p in payloads]) * wn).sum()
    if codec is not None:
        n_params = max(payloads[0].num_params(), 1)
        bits = col([codec.measure_bits(p) for p in payloads])
        side = col([codec.sidecar_bits(p) for p in payloads])
        out["uplink_bpp_measured"] = (bits * wn).sum() / n_params
        out["uplink_bits_measured"] = ((bits + side) * pf).sum()
    if dl_payload is not None:
        out["downlink_bpp"] = dl_payload.bpp()
        out["downlink_bits"] = torch.tensor(
            float(dl_payload.wire_bits() + dl_payload.sidecar_bits()),
            dtype=torch.float32, device=wn.device) * n_part
    else:
        out["downlink_bpp"] = torch.tensor(0.0)
        out["downlink_bits"] = torch.tensor(0.0)
    return new_state, out


class FedAlgorithm:
    """The protocol's concrete carrier, plus `round`.

    `round(state, data, participation, sizes, generator=None,
    uniforms=None)` is `run_round` with the algorithm's codec.  `codec`
    (a name or an `api.codecs.Codec`) picks the codec the round meters
    uplinks with, by default the payload spec's.  `downlink(state,
    generator, u)` -> (DownlinkPayload, client state) is the per-round
    broadcast.  `pooled_aggregate(state, q, floats, k)` (optional) is the
    aggregator tree's seam: the transition of `aggregate` given the
    already-reduced weighted mask mean `q`, the pooled float leaves and
    the folded client count `k` (`runtime.agg_tree`).  The state `init`
    returns owns its tensors (the float leaves are copied out of the
    caller's template)."""

    def __init__(self, name: str, *, init: Callable,
                 client_update: Callable, aggregate: Callable,
                 eval_params: Callable, payload_spec: PayloadSpec,
                 codec=None, downlink: Optional[Callable] = None,
                 pooled_aggregate: Optional[Callable] = None):
        self.name = name
        self.init = lambda gen, params_like: tu.tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
            init(gen, params_like))
        self.client_update = client_update
        self.aggregate = aggregate
        self.eval_params = eval_params
        self.payload_spec = payload_spec
        self.codec = codecs_lib.resolve(codec, payload_spec)
        self.downlink = downlink
        self.pooled_aggregate = pooled_aggregate

    def round(self, state, data, participation, sizes, generator=None,
              uniforms=None):
        return run_round(self, state, data, participation, sizes,
                         generator, uniforms=uniforms)

    def __repr__(self):
        return (f"FedAlgorithm({self.name!r}, "
                f"payload={self.payload_spec.cls.__name__}, "
                f"codec={self.codec.name!r})")


@torch.no_grad()
def evaluate(algo: FedAlgorithm, state, batch, apply_fn: Callable,
             metric_fn: Callable, generator=None, n_samples: int = 1,
             uniforms: Optional[list] = None):
    """The mean metric over `n_samples` sampled effective networks
    (`uniforms`: one `eval_params` u a sample)."""
    total = 0.0
    for i in range(n_samples):
        eff = algo.eval_params(state, generator,
                               None if uniforms is None else uniforms[i])
        total = total + metric_fn(apply_fn(eff, batch), batch)
    return total / n_samples
