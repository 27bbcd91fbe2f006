"""Serving launcher of the PyTorch port: single-tenant batched decode,
or the multi-tenant continuous-batching engine over one shared frozen
weight copy.

    python -m repro_torch.launch.serve --arch gemma3-4b --tokens 16
    python -m repro_torch.launch.serve --arch gemma3-4b \
        --tenants 4 --slots 2 --cache-capacity 2 --tokens 16 [--lockstep]

Runs on the CUDA card by default and raises if there is none; the CPU is
used only when asked for (`--device cpu`, with `--smoke` for the reduced
config).  A deployed mask is static, so each tenant's tree is frozen once
(`masking.freeze_identity`, the threshold mask a FedMask artifact ships)
and every decode step reuses plain m * w products: no mask is resampled
while serving.

`--arch` defaults to gemma3-4b, as the reference launcher does, and takes
every arch of the zoo (`configs.ARCH_NAMES`: dense, MoE, VLM, encdec, ssm
and hybrid).  qwen2-vl decodes text only, with 1-D rope; whisper decodes
against the zero cross K/V that `init_cache` makes, as the reference
launcher does.

Single tenant: one warm-up step off the clock, then `time.perf_counter`
after a device synchronize around each step, prefill and decode tok/s
reported apart.  Multi-tenant (`--tenants` > 1): one request per tenant,
distinct mask seeds, through `runtime.serve_engine.ServeEngine`; with
`--lockstep` the engine advances all slots in one vmapped step a tick
(numerically equivalent to the exact per-slot mode, not bit-exact).
`main` returns a summary (tok/s, seconds, cache stats, bytes).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import masking
from repro_torch.launch.train import resolve_device
from repro_torch.models import build_model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _serve_single(args, cfg, api, gen, mp, dev) -> dict:
    """Batched greedy decode of one tenant: `--batch` requests of a
    `--prompt-len` prompt, each step one token of every request."""
    ident = masking.MaskIdentity(seed=args.seed, mode="threshold")
    _sync(dev)
    t0 = time.perf_counter()
    eff = masking.freeze_identity(mp, ident)
    _sync(dev)
    freeze_s = time.perf_counter() - t0

    B, P = args.batch, args.prompt_len
    S = P + args.tokens
    serve = api.decode_step
    cache = api.init_cache(B, S, dev)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)

    # warm-up off the clock: one step on a scratch cache
    serve(eff, api.init_cache(B, S, dev), prompt[:, 0], 0)
    _sync(dev)

    tok = prompt[:, 0]
    prefill_s = decode_s = 0.0
    generated = []
    logits = None
    for t in range(S - 1):
        t0 = time.perf_counter()
        logits, cache = serve(eff, cache, tok, t)
        _sync(dev)
        dt = time.perf_counter() - t0
        if t + 1 < P:
            prefill_s += dt
            tok = prompt[:, t + 1]
        else:
            decode_s += dt
            tok = torch.argmax(logits, -1)
            generated.append(tok)
    pre_tok = B * (P - 1)
    dec_tok = B * args.tokens
    print(f"{cfg.name}: {B} requests, prefill {pre_tok} tok in "
          f"{prefill_s:.3f}s ({pre_tok / max(prefill_s, 1e-9):.1f} tok/s), "
          f"decode {dec_tok} tok in {decode_s:.3f}s "
          f"({dec_tok / max(decode_s, 1e-9):.1f} tok/s)")
    return {"prefill_tokens": pre_tok, "prefill_s": prefill_s,
            "prefill_tok_s": pre_tok / max(prefill_s, 1e-9),
            "decode_tokens": dec_tok, "decode_s": decode_s,
            "decode_tok_s": dec_tok / max(decode_s, 1e-9),
            "freeze_s": freeze_s, "freezes": 1,
            "weight_bytes": masking.masked_delta_bytes(mp),
            "mask_artifact_bytes": masking.mask_artifact_bytes(mp),
            "last_logits": logits, "tokens": torch.stack(generated, 1)}


def _serve_multi(args, cfg, api, gen, mp, dev) -> dict:
    """Multi-tenant continuous batching: every tenant is a mask identity
    over the same `mp.weights`; the engine's freeze-cache bounds the
    resident frozen trees to `--cache-capacity`."""
    from repro_torch.runtime.serve_engine import ServeEngine

    eng = ServeEngine(api, mp, slots=args.slots,
                      cache_capacity=args.cache_capacity,
                      max_seq=args.prompt_len + args.tokens,
                      lockstep=args.lockstep)
    prompts = torch.randint(0, cfg.vocab, (args.tenants, args.prompt_len),
                            generator=gen, device=dev).cpu().numpy()
    for i in range(args.tenants):
        eng.register_tenant(f"tenant{i}", seed=args.seed + i)
        eng.submit(f"tenant{i}", prompts[i], args.tokens)
    done = eng.run()
    st = eng.stats()
    print(f"{cfg.name}: {len(done)}/{args.tenants} tenants served on "
          f"{args.slots} slots (freeze-cache {st['occupancy']}/"
          f"{st['capacity']}, {st['hits']} hits / {st['misses']} misses"
          f" / {st['evictions']} evictions)")
    print(f"  prefill {st['prefill_tokens']} tok "
          f"({st['prefill_tok_s']:.1f} tok/s), "
          f"decode {st['decode_tokens']} tok "
          f"({st['decode_tok_s']:.1f} tok/s)")
    print(f"  resident HBM: 1 x w ({st['weight_bytes']} B) + "
          f"{st['resident_tree_count']} x delta "
          f"({st['delta_bytes_per_tree']} B) = {st['resident_bytes']} B "
          f"for {st['tenants']} tenants "
          f"(mask artifact {st['mask_artifact_bytes']} B/tenant)")
    return dict(st, served=len(done), completions=done,
                lockstep=args.lockstep)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="the frozen random network's seed and the first "
                         "tenant's mask seed")
    ap.add_argument("--tenants", type=int, default=1,
                    help=">1 drives the multi-tenant engine: one request "
                         "per tenant, distinct mask seeds")
    ap.add_argument("--slots", type=int, default=2,
                    help="concurrent batch slots (multi-tenant)")
    ap.add_argument("--cache-capacity", type=int, default=2,
                    help="freeze-cache bound on resident trees")
    ap.add_argument("--lockstep", action="store_true",
                    help="one vmapped step for all slots a tick "
                         "(multi-tenant; not bit-exact)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(get_config(args.arch, smoke=args.smoke), args)


def run(cfg, args: argparse.Namespace) -> dict:
    """Serve `cfg` as the parsed command line `args` asks (its --arch and
    --smoke aside), so that a caller may serve a config cut in depth."""
    dev = resolve_device(args.device)
    # the reference's attention and unembed products are full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    api = build_model(cfg)
    # --seed picks the frozen random network; the deployed threshold mask
    # is a function of the scores
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    mp = masking.init_masked(gen, api.init_params(gen), masking.MaskSpec())
    if args.tenants > 1:
        return _serve_multi(args, cfg, api, gen, mp, dev)
    return _serve_single(args, cfg, api, gen, mp, dev)


if __name__ == "__main__":
    main()
