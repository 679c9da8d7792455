"""Batched serving example: the JAX package's ``examples/serve_batch.py``
as a module of ``repro_torch``, with the same flags and defaults: prefill a
batch of prompts, then greedy-decode with a fixed-length KV cache (the code
path the decode_32k dry-run cells cost at pod scale). It runs on the card
unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python -m repro_torch.serve_batch [--arch qwen3_14b]
          [--device cuda]
(any arch id works; smoke-sized weights are used so every family runs on
the CPU)
"""

from __future__ import annotations

import argparse

from repro_torch.launch import serve


def main(argv=None):
    """Returns the generated tokens [batch, gen] (on the device)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_14b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' only when asked for")
    args = ap.parse_args(argv)
    return serve.main(["--arch", args.arch, "--smoke", "--batch",
                       str(args.batch), "--prompt-len", "12", "--gen",
                       str(args.gen), "--device", args.device])


if __name__ == "__main__":
    main()
