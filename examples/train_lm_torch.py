"""End-to-end training example on the PyTorch port: a granite-style model
trained on the DILI-backed record-store pipeline, with checkpoint/auto-resume
and simulated node failure.  Port of `examples/train_lm.py`.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --steps 200 \\
        --fail-at-step 60
    # rerun the same command: it auto-resumes from the last checkpoint

Scaled by --preset: `cpu` (default, small dims) or `100m` (the full
~100M-param config; same code path).  The model, its state and the record
store's index live on --device (CUDA unless asked otherwise); each batch's
document lookup is one launch of the lookup kernel's f64/i64 instance on
the card.  `main` returns the losses of the steps it ran, the step it
started at and the final state.
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import StorePipeline, SyntheticLM
from repro_torch.data.record_store import RecordStore
from repro_torch.device import resolve_device
from repro_torch.train import step as STEP
from repro_torch.train.optim import adamw, cosine_schedule


def build_cfg(preset: str):
    base = get_config("granite-8b")
    if preset == "100m":
        return dataclasses.replace(
            base, name="granite-100m", n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=4, d_ff=2048, vocab=32768, head_dim=64,
            dtype="float32", remat="none")
    return dataclasses.replace(
        base, name="granite-tiny", n_layers=4, d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab=512, head_dim=64, dtype="float32",
        remat="none")


def build_store(cfg, n_docs=2000, doc_len=129, seed=0, device="cuda"):
    """Corpus in a DILI record store; documents carry the synthetic
    next-token structure so the model demonstrably learns."""
    gen = SyntheticLM(cfg.vocab, doc_len - 1, 1, seed=seed)
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.uniform(0, 1e9, n_docs))
    docs = []
    for i in range(len(keys)):
        b = gen.batch_at(i)
        docs.append(np.concatenate([b["tokens"][0], b["labels"][0][-1:]])
                    .astype(np.int32))
    return RecordStore(keys, docs, device=device), keys


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--preset", default="cpu")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=0,
                    help="simulate a node failure at this step")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = build_cfg(args.preset)
    opt = adamw(lr=3e-3, schedule=cosine_schedule(3e-3, 20, args.steps))
    store, keys = build_store(cfg, device=dev)
    pipe = StorePipeline(store, keys, seq_len=args.seq, batch=args.batch)

    state = STEP.init_state(cfg, opt, device=dev)
    manifest = STEP.restore_state(args.ckpt_dir, state)
    if manifest is None:
        start = 0
        print("[train] cold start")
    else:
        start = manifest["step"]
        print(f"[train] resumed from step {start}")

    train_step = STEP.make_train_step(cfg, opt)
    losses = []
    t0 = time.time()
    try:
        for step in range(start, args.steps):
            if args.fail_at_step and step == args.fail_at_step:
                print(f"[train] SIMULATED NODE FAILURE at step {step} — "
                      "rerun to auto-resume")
                sys.exit(42)
            batch = pipe.batch_at(step)      # DILI-backed lookup path
            state, metrics = train_step(state, {
                k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
            losses.append(metrics["loss"])
            if step % 20 == 0 or step == args.steps - 1:
                print(f"step {step:4d} loss={float(metrics['loss']):.4f} "
                      f"gnorm={float(metrics['grad_norm']):.2f} "
                      f"({(time.time() - t0):.0f}s)")
            if (step + 1) % args.ckpt_every == 0:
                STEP.save_state(args.ckpt_dir, step + 1, state,
                                extra={"data_step": step + 1})
    finally:
        store.index.close()
    print("[train] done; final loss should be well below the ~ "
          f"{np.log(cfg.vocab):.2f} random-guess floor")
    return dict(losses=[float(x) for x in losses], start=start, state=state,
                cfg=cfg)


if __name__ == "__main__":
    main()
