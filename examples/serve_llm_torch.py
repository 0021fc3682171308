"""Serving example on the PyTorch/CUDA port: batched requests against a
small model with a DILI session table on the admission/KV-slot path
(Algorithms 7/8 in serving).  Counterpart of `examples/serve_llm.py`; the
model, its KV cache and the session table live on the GPU unless
`--device cpu` asks for the CPU:

    PYTHONPATH=src python examples/serve_llm_torch.py --requests 24 \\
        --tokens 16 [--device cuda|cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model as MDL
from repro_torch.serve.sessions import SessionTable
from repro_torch.train import step as STEP


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(
        get_config("granite-8b"), name="granite-serve", n_layers=4,
        d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
        head_dim=64, dtype="float32")
    params = MDL.init_params(cfg, device=dev)

    sessions = SessionTable(n_slots=args.batch + 4, device=dev)
    rng = np.random.default_rng(0)
    max_len = args.prompt_len + args.tokens + 1

    t0 = time.time()
    done = 0
    req_id = 1000.0
    while done < args.requests:
        # admit a batch of sessions (DILI insert path)
        batch_ids = []
        for _ in range(args.batch):
            req_id += 1.0
            sessions.admit(req_id)
            batch_ids.append(req_id)
        _, found = sessions.lookup_batch(batch_ids)
        if not found.all():
            raise RuntimeError("admitted sessions do not resolve")

        prompts = rng.integers(0, cfg.vocab,
                               (args.batch, args.prompt_len)).astype(np.int32)
        cache = MDL.make_cache(cfg, args.batch, max_len, device=dev)
        toks, _ = STEP.greedy(
            params, cfg, dict(tokens=torch.from_numpy(prompts).to(dev)),
            cache, args.tokens - 1)
        gen = toks.cpu().numpy()
        if gen.shape != (args.batch, args.tokens):
            raise RuntimeError(f"generated {gen.shape}")

        # evict (DILI delete path; slots recycled)
        for rid in batch_ids:
            sessions.evict(rid)
        done += args.batch
    dt = time.time() - t0
    total_toks = args.requests * args.tokens
    print(f"[serve] {done} requests, {total_toks} generated tokens in "
          f"{dt:.1f}s ({total_toks / dt:.0f} tok/s incl. prefill+sessions)")
    print(f"[serve] session-table stats: {sessions.dili.stats()}")
    sessions.index.close()


if __name__ == "__main__":
    main()
