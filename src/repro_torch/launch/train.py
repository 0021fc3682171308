"""Training launcher: model state, synthetic pipeline, checkpoint/auto-resume,
straggler deadline.  Port of `repro/launch/train.py`; the state lives on
`--device` (CUDA unless asked otherwise).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --steps 100 --batch 8 --seq 128 --reduced --device cpu

Fault tolerance: every --ckpt-every steps the state is written atomically
through `ft` in the reference's layout (`train.step.save_state`); on
restart the newest valid checkpoint is restored (corrupt ones are skipped,
and so is every checkpoint of a bf16 model, as in the reference).  A
per-step deadline flags stragglers (logs and continues).

`--mesh local` is the one card, a (1, 1) mesh; the state's shardings come
from the reference's rules on that mesh (`parallel.sharding`), where every
placement is the identity.  A production mesh (`16x16`, `2x16x16`) needs
256 or 512 devices: the launcher raises `ValueError` naming them and the
one device present, before any state is built, as the reference's
`jax.make_mesh` fails on a host with one device.  Size those meshes'
cells with the dry run (`python -m repro_torch.launch.dryrun`).

`main` returns the per-step losses (floats, from the first step this run
took), the step it started at and the final state.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from ..configs import get_config
from ..data.pipeline import SyntheticLM
from ..device import resolve_device
from ..parallel import sharding as SH
from ..train import step as STEP
from ..train.optim import adafactor, adamw, cosine_schedule
from .mesh import check_devices, make_local_mesh, make_production_mesh


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--mesh", default="local",
                    help="local | 16x16 | 2x16x16")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--step-deadline-s", type=float, default=0.0,
                    help="straggler deadline per step (0 = off)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, accum_steps=1)

    if args.mesh == "local":
        mesh = make_local_mesh()
    else:
        mesh = make_production_mesh(multi_pod=args.mesh.count("x") == 2)
    check_devices(mesh, dev)

    opt = (adafactor(lr=args.lr) if cfg.d_model >= 5120
           else adamw(lr=args.lr,
                      schedule=cosine_schedule(args.lr, 20, args.steps)))

    pipe = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0)
    shardings = dict(
        params=SH.param_shardings(cfg, mesh, STEP.params_shape(cfg)))
    state = STEP.init_state(cfg, opt, device=dev)
    manifest = STEP.restore_state(args.ckpt_dir, state)
    if manifest is None:
        start = 0
        print("[launch] cold start", flush=True)
    else:
        start = manifest["step"]
        print(f"[launch] resumed from step {start}", flush=True)
    train_step = STEP.make_train_step(cfg, opt)
    losses = []
    for step in range(start, args.steps):
        t0 = time.time()
        b = pipe.batch_at(step)
        state, m = train_step(state, {k: torch.from_numpy(v).to(dev)
                                      for k, v in b.items()})
        losses.append(m["loss"])
        dt = time.time() - t0
        if args.step_deadline_s and dt > args.step_deadline_s:
            print(f"[straggler] step {step} took {dt:.2f}s "
                  f"> deadline {args.step_deadline_s}s — flagged",
                  flush=True)
        if step % 10 == 0:
            print(f"step {step} loss={float(m['loss']):.4f} "
                  f"({dt:.2f}s/step)", flush=True)
        if (step + 1) % args.ckpt_every == 0:
            STEP.save_state(args.ckpt_dir, step + 1, state)
    print("[launch] done")
    return dict(losses=[float(x) for x in losses], start=start, state=state,
                cfg=cfg, mesh=mesh, shardings=shardings)


if __name__ == "__main__":
    main()
