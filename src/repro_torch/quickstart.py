"""Quickstart of the port: the JAX package's ``examples/quickstart.py`` as a
module of ``repro_torch``, in the same four sections:

  1. the structured tasking façade: TaskScope / parallel_for over the
     paper's Relic runtime (scope exit is the barrier);
  2. one train step of a model from the zoo (AdamW, global-norm clipping);
  3. eight greedy decode steps from the trained parameters;
  4. the paper's kernel: ``ops.matmul`` (relic_matmul, a hand-written CUDA
     kernel on the card) against its oracle.

It runs the full config on the card unless ``--smoke`` / ``--device cpu``
are given; ``--device cuda`` without a card raises.

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--arch relic_tiny]
          [--smoke] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.steps import (make_serve_step, make_train_state,
                                      make_train_step)
from repro_torch.models import build_model
from repro_torch.optim import OptConfig
from repro_torch.tasks import TaskScope, parallel_for

BATCH, SEQ, CACHE_LEN, DECODE_STEPS = 4, 64, 16, 8


def tasking_demo():
    """Section 1: returns (squares, their sum from a future)."""
    squares = [0] * 8
    with TaskScope("relic") as scope:   # Relic assistant spun up for the scope
        scope.wake_up_hint()            # a parallelizable section is coming
        # worksharing loop: chunks of 2 indices; the main thread runs the
        # final chunk itself (the paper's producer-participates pattern)
        parallel_for(scope, 8, lambda i: squares.__setitem__(i, i * i), grain=2)
        total = scope.submit(sum, squares)   # futures, too: a TaskHandle
        # scope exit = barrier; task errors (none here) would raise together
    print("parallel_for squares:", squares, "| sum future:", total.result())
    return squares, total.result()


def train_and_decode(model, state: dict, rng: np.random.Generator, device):
    """Sections 2 and 3: one train step on a batch drawn from ``rng``, then
    greedy decode steps from random tokens with the trained parameters.
    Returns (state, metrics, last tokens [BATCH, 1])."""
    vocab = model.cfg.vocab_size

    def draw(shape):
        return torch.as_tensor(rng.integers(0, vocab, shape), device=device)

    batch = {"tokens": draw((BATCH, SEQ)), "labels": draw((BATCH, SEQ)),
             "mask": torch.ones((BATCH, SEQ), device=device)}
    train_step = make_train_step(model, OptConfig(total_steps=100))
    state, metrics = train_step(state, batch)
    print(f"train step: loss={float(metrics['loss']):.4f} "
          f"gnorm={float(metrics['grad_norm']):.3f}")

    serve_step = make_serve_step(model)
    cache = model.init_cache(BATCH, CACHE_LEN)
    tok = draw((BATCH, 1))
    for t in range(DECODE_STEPS):
        tok, _, cache = serve_step(state["params"], cache, tok, t)
    print("decoded tokens:", tok[:, 0].cpu().numpy())
    return state, metrics, tok


def matmul_demo(rng: np.random.Generator, device) -> float:
    """Section 4: ``ops.matmul`` at [128, 256] @ [256, 128] f32 against
    ``ref.matmul_ref``, held at tests/test_kernels.py's f32 tolerance.
    Returns the largest absolute difference."""
    x = torch.as_tensor(rng.normal(size=(128, 256)), dtype=torch.float32,
                        device=device)
    w = torch.as_tensor(rng.normal(size=(256, 128)), dtype=torch.float32,
                        device=device)
    out = ops.matmul(x, w, bm=128, bn=128, bk=128)   # relic_matmul
    want = ref.matmul_ref(x, w)
    err = (out - want).abs().max().item()
    torch.testing.assert_close(out, want, rtol=2e-4, atol=1e-2)
    print(f"relic_matmul ({'CUDA kernel' if out.is_cuda else 'plain version'} "
          f"on {device}): max err vs oracle = {err:.2e}")
    return err


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="relic_tiny")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' only when asked for")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    squares, total = tasking_demo()

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device)
    state = make_train_state(model, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"model: {cfg.name} ({n_params / 1e6:.2f}M params) on {device}")
    rng = np.random.default_rng(0)
    state, metrics, tok = train_and_decode(model, state, rng, device)

    err = matmul_demo(rng, device)
    print("quickstart OK")
    return {"squares": squares, "total": total, "metrics": metrics,
            "tokens": tok, "matmul_err": err}


if __name__ == "__main__":
    main()
