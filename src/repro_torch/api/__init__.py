"""`repro_torch.api`, the federated-learning surface (`repro.api`): one
protocol (`FedAlgorithm`), one registry (`register` / `get_algorithm`),
typed payloads in both directions (`BitpackedMasks`, `SignVotes`,
`FloatDeltas` up; `ProbBroadcast`, `FloatBroadcast` down) and pluggable
wire codecs (`api.codecs`: `bitpack`, `golomb`, `arithmetic`,
`signpack`, `float32`), whose real serialized size is the measured
communication metric.  The `CommLedger` adds up two-way wire bytes
across a run."""
from repro_torch.api.codecs import (  # noqa: F401
    ArithmeticBernoulli, Bitpack32, Codec, CommLedger, Float32Raw,
    GolombRice, SignPack, WireMessage, get_codec, resolve as resolve_codec)
from repro_torch.api.codecs import available as available_codecs  # noqa
from repro_torch.api.payloads import (  # noqa: F401
    BitpackedMasks, DownlinkPayload, FloatBroadcast, FloatDeltas,
    ProbBroadcast, SignVotes, UplinkPayload, batched_float_mean,
    batched_packed_mean, mean_from_words, pack_leaf, slice_payload,
    stack_payloads)
from repro_torch.api.protocol import (  # noqa: F401
    FedAlgorithm, PayloadSpec, SupportsFedAlgorithm, client_view, evaluate,
    run_round)
from repro_torch.api.registry import (  # noqa: F401
    AlgorithmEntry, available, get_algorithm, get_entry, get_launch_plan,
    launchable, register, register_launch)
from repro_torch.api import algorithms  # noqa: F401  (registers the six)
