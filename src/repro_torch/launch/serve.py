"""Serving launcher: prefill/decode engine + DILI session table behind
the concurrent serving front-end (DESIGN.md section 15).  Port of
`repro/launch/serve.py`; the model, the KV cache and the session table's
index live on `--device` (CUDA unless asked otherwise).

Session admits/evicts/lookups do not call the index facade directly:
a `ServeFrontend` batches them through `repro_torch.serve`, and the
admit/evict bookkeeping for each decode batch runs on `--frontend-threads`
concurrent client threads — the same shape a real deployment has (many
request handlers, one batcher, one index writer).  Each session lookup is
one launch of the lookup kernel's f64/i64 instance on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --reduced --device cpu --requests 16 --tokens 8 --frontend-threads 4

`main` returns what it served (the model, prompts, generated tokens,
whether every logit was finite, the init seconds, the front-end's stats,
and for each decode batch its session ids, the KV slots their admits
returned and the slots the session lookup resolved them to).
"""

from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import model as MDL
from ..serve.frontend import ServeFrontend
from ..serve.sessions import SessionTable
from ..train import step as STEP


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, on_lookup=None) -> dict:
    """`on_lookup(sessions, ids)`, when given, is called after each decode
    batch's session lookup, before that batch is evicted: the table holds
    the state that lookup read."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--frontend-threads", type=int, default=4,
                    help="concurrent session-admission threads")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    t0 = time.perf_counter()
    params = MDL.init_params(cfg, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    sessions = SessionTable(n_slots=args.batch + 4, device=dev)
    frontend = ServeFrontend(sessions.index)
    sessions.serve_through(frontend)
    pool = ThreadPoolExecutor(max_workers=args.frontend_threads,
                              thread_name_prefix="frontend")
    rng = np.random.default_rng(0)
    max_len = args.prompt_len + args.tokens + 1
    kw = {}
    if cfg.family == "vlm":
        kw["extra_embeds"] = torch.zeros(
            (args.batch, cfg.frontend_seq, cfg.d_model), device=dev)
        max_len += cfg.frontend_seq
    if cfg.is_encdec:
        kw["enc_frames"] = torch.zeros(
            (args.batch, cfg.frontend_seq, cfg.d_model), device=dev)

    prompts_all, generated, slots = [], [], []
    finite = torch.ones((), dtype=torch.bool, device=dev)
    done, rid, t0 = 0, 1000.0, time.perf_counter()
    try:
        while done < args.requests:
            ids = []
            for _ in range(args.batch):
                rid += 1.0
                ids.append(rid)
            # admits fan out across the frontend threads; each admit is a
            # get+upsert pair through the batcher under the table lock
            admitted = list(pool.map(sessions.admit, ids))
            # KV-slot resolution for the decode batch rides the batched
            # lookup path (coalesced with any other serving traffic)
            resolved, found = sessions.lookup_batch(ids)
            if not found.all():
                raise RuntimeError(f"admitted sessions do not resolve: "
                                   f"{np.asarray(ids)[~found]}")
            if on_lookup is not None:
                on_lookup(sessions, ids)
            slots.append(dict(ids=np.asarray(ids),
                              admitted=np.asarray(admitted, np.int64),
                              resolved=np.asarray(resolved, np.int64)))
            prompts = rng.integers(
                0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
            cache = MDL.make_cache(cfg, args.batch, max_len, device=dev)
            batch = dict(tokens=torch.from_numpy(prompts).to(dev), **kw)
            toks, logits = STEP.greedy(params, cfg, batch, cache,
                                       args.tokens - 1)
            for lg in logits:
                finite &= torch.isfinite(lg).all()
            generated.append(toks.cpu().numpy())
            prompts_all.append(prompts)
            list(pool.map(sessions.evict, ids))
            done += args.batch
    finally:
        pool.shutdown(wait=True)
        stats = frontend.stats()
        frontend.close()
        sessions.index.close()
    dt = time.perf_counter() - t0
    print(f"[serve] {cfg.name} on {dev}: init {init_s:.2f}s; {done} requests "
          f"x {args.tokens} tokens in {dt:.1f}s "
          f"({done * args.tokens / dt:.1f} tok/s)")
    print(f"[serve] frontend: {stats['accepted_ops']} ops in "
          f"{stats['n_batches']} batches "
          f"(mean {stats['batch_ops_mean']:.1f} ops/batch, "
          f"shed {stats['shed_ops']})")
    return dict(cfg=cfg, model=params, prompts=np.concatenate(prompts_all),
                generated=np.concatenate(generated),
                logits_finite=bool(finite), init_s=init_s, serve_s=dt,
                tok_per_s=done * args.tokens / dt, frontend=stats,
                slots=slots)


if __name__ == "__main__":
    main()
