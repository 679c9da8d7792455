"""Training driver: data pipeline (Relic-prefetched) -> train step ->
async checkpointing -> straggler monitoring, on one card.

The port of ``src/repro/launch/train.py``: the same command line and log,
without the mesh, the shardings and ``jit`` (PyTorch runs the step
eagerly). Batches come from ``repro_torch.data.PrefetchPipeline`` (an
assistant thread produces them while the loop trains), checkpoints go
through ``repro_torch.checkpoint.CheckpointManager`` (serialize -> publish
stages on the Relic substrate) in the reference's format, and ``--resume``
restores onto the device. Weights come from
``torch.Generator().manual_seed(0)``. It runs on the card unless
``--device cpu`` is given.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch relic_tiny \
      --steps 200 --batch 8 --seq 256 --ckpt /tmp/ckpt
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, PrefetchPipeline, SyntheticLM
from repro_torch.devices import resolve_device
from repro_torch.launch.steps import make_train_state, make_train_step
from repro_torch.models import build_model
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.optim import OptConfig
from repro_torch.runtime import StragglerMonitor


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="relic_tiny")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-checksum", default="on", choices=["on", "off"],
                    help="per-entry CRC32 in the checkpoint manifest "
                         "(verified on restore)")
    ap.add_argument("--ckpt-chaos", default="",
                    help="chaos: crash the Nth save at a named fs point, "
                         "as point[:at_save] (e.g. 'manifest:1'); points: "
                         "serialize-start, entry, manifest, pre-publish")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' only when asked for")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device)
    oc = OptConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                   total_steps=args.steps)

    dc = DataConfig(seq_len=args.seq, global_batch=args.batch,
                    vocab_size=cfg.vocab_size)
    pipe = PrefetchPipeline(SyntheticLM(dc), dc).start()
    try:
        state = make_train_state(model, torch.Generator().manual_seed(0))
        step_fn = make_train_step(model, oc)

        mgr = None
        if args.ckpt:
            mgr = CheckpointManager(
                args.ckpt,
                # Chaos runs save synchronously so the injected FsCrash
                # unwinds the driver at the exact write point — the
                # closest single-process stand-in for dying mid-save.
                async_=not args.ckpt_chaos,
                checksum=args.ckpt_checksum == "on")
            if args.ckpt_chaos:
                from repro_torch.runtime.chaos import FsFaultInjector
                point, _, at_save = args.ckpt_chaos.partition(":")
                FsFaultInjector(crash_point=point,
                                at_save=int(at_save or 0)).arm(mgr)
        start = 0
        if mgr and args.resume and mgr.latest_step() is not None:
            tree, start = mgr.restore(train_state_to_numpy(state),
                                      device=device)
            state = train_state_from_numpy(cfg, tree, device)
            print(f"resumed from step {start}")

        mon = StragglerMonitor(n_hosts=1)
        t_last = time.time()
        for i in range(start, args.steps):
            batch = {k: torch.as_tensor(v).to(device)
                     for k, v in pipe.next_batch().items()}
            state, metrics = step_fn(state, batch)
            if (i + 1) % args.log_every == 0 or i == start:
                loss = float(metrics["loss"])
                dt_step = (time.time() - t_last) / args.log_every
                mon.record(0, dt_step)
                t_last = time.time()
                print(f"step {i+1:5d}  loss {loss:.4f}  "
                      f"lr {float(metrics['lr']):.2e}  "
                      f"gnorm {float(metrics['grad_norm']):.3f}  "
                      f"{dt_step*1e3:.0f} ms/step", flush=True)
            if mgr and (i + 1) % args.ckpt_every == 0:
                # async on the Relic assistant; the host copy is taken here
                mgr.save(train_state_to_numpy(state), i + 1)
        if mgr:
            mgr.save(train_state_to_numpy(state), args.steps, block=True)
            mgr.close()
    finally:
        # A chaos FsCrash (or any error) must not leak the prefetch
        # threads into the caller's process — the resume test runs
        # main() twice in-process.
        pipe.stop()
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
