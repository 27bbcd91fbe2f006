"""Serving example: a (seed, bitpacked-mask) artifact is unpacked over
the frozen weights its seed regenerates, and the sparse sub-network
decodes batched requests over a KV cache: the paper's "seed + binary
mask is the whole model", live.

    python -m repro_torch.examples.serve_masked [--device cpu]

On the card the masks unpack through kernel 11 (`unpack_bits`), one
launch a masked leaf, and every token runs `steps.make_serve_step`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import aggregation, federated, masking
from repro_torch.core import tree as tu
from repro_torch.launch import steps as steplib
from repro_torch.launch.train import resolve_device
from repro_torch.models import build_model

SEED = 0
CFG = ArchConfig(name="serve-demo", family="dense", n_layers=4, d_model=256,
                 n_heads=4, n_kv_heads=2, d_ff=1024, vocab=4096,
                 head_dim=64)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8, help="requests")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    api = build_model(CFG)
    spec = masking.MaskSpec()

    # --- "train side": produce the artifact ---------------------------
    gen = torch.Generator(dev).manual_seed(SEED)
    server = federated.init_server(gen, api.init_params(gen), spec)
    art = federated.final_artifact(server, gen)
    n = sum(int(np.prod(sh)) for _, (w, sh) in art["masks"].items())
    packed_bytes = sum(int(w.numel()) * 4 for _, (w, sh)
                       in art["masks"].items())
    print(f"artifact: {n} masked params -> {packed_bytes} packed bytes "
          f"({8*packed_bytes/n:.2f} bits/param)")

    # --- "serve side": regenerate the weights from the seed, apply the
    # masks (the same draws from a generator seeded alike)
    regen = torch.Generator(dev).manual_seed(art["seed"])
    mp = masking.init_masked(regen, api.init_params(regen), spec)

    def materialize(path, w):
        if w is None or path not in art["masks"]:
            return w
        words, shape = art["masks"][path]
        m = aggregation.unpack_bits(words, int(np.prod(shape)))
        return m.reshape(shape).to(w.dtype) * w

    paths = [p for p, _ in tu.flatten_with_paths(mp.weights)]
    flat, tdef = tu.flatten(mp.weights)
    eff = tu.unflatten(tdef, [materialize(p, w)
                              for p, w in zip(paths, flat)])
    # the float leaves from the regenerated init
    eff = tu.tree_map(lambda e, f: f if e is None else e, eff, mp.floats)

    # --- batched decode ------------------------------------------------
    B, prompt_len, n_gen = args.batch, args.prompt_len, args.gen_tokens
    serve = steplib.make_serve_step(api)
    cache = api.init_cache(B, prompt_len + n_gen, dev)
    prompt = torch.randint(0, CFG.vocab, (B, prompt_len), generator=gen,
                           device=dev)
    # prefill by stepping (the simple reference path)
    tok = prompt[:, 0]
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        for t in range(prompt_len + n_gen - 1):
            logits, cache = serve(eff, cache, tok, t)
            tok = (prompt[:, t + 1] if t + 1 < prompt_len
                   else torch.argmax(logits, -1))
    sync()
    dt = time.perf_counter() - t0
    print(f"decoded {n_gen} tokens x {B} requests in {dt:.2f}s "
          f"({B*n_gen/dt:.1f} tok/s on {dev.type})")
    print("sample continuation ids:", tok.cpu().numpy()[:8])
    return {"masked_params": n, "packed_bytes": packed_bytes,
            "tok_s": B * n_gen / dt, "tokens": tok.cpu()}


if __name__ == "__main__":
    main()
