"""End-to-end training driver example: the JAX package's
``examples/train_lm.py`` as a module of ``repro_torch``, with the same flags
and defaults; it runs on the card unless ``--device cpu`` is given.

Default runs a fast CPU-sized config; pass --full to train the ~100M
`relic_tiny` config for a few hundred steps.

The loop underneath (``repro_torch.launch.train``) includes:
  * Relic-prefetched data pipeline (SPSC assistant thread)
  * async checkpointing every --ckpt-every steps on the Relic assistant
  * resume with --resume (deterministic: same stream, same loss curve)
  * straggler monitor hooks

Run:  PYTHONPATH=src python -m repro_torch.train_lm [--full] [--steps 300]
          [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch import train


def driver_argv(args) -> list:
    """The command line the example hands ``launch.train``: the reference
    example's, then the device."""
    if args.full:
        argv = ["--arch", "relic_tiny", "--steps", str(args.steps or 300),
                "--batch", "8", "--seq", "512", "--ckpt", args.ckpt,
                "--ckpt-every", "50"]
    else:
        argv = ["--arch", "relic_tiny", "--smoke", "--steps",
                str(args.steps or 120), "--batch", "8", "--seq", "128",
                "--ckpt", args.ckpt, "--ckpt-every", "40"]
    if args.resume:
        argv.append("--resume")
    return argv + ["--device", args.device]


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M params, a few hundred steps")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "relic_train_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' only when asked for")
    args = ap.parse_args(argv)
    final_loss = train.main(driver_argv(args))
    print(f"final loss: {final_loss:.4f}")
    return final_loss


if __name__ == "__main__":
    main()
