"""Serving entry point: batched prefill + greedy decode, served as a streaming
request through ``repro_torch.serve.ServeScheduler``.

The decode loop is a *generator* work function — each generated token is
one yielded item, so the response's ``first_result_t`` is the
time-to-first-token and the subsystem's latency accounting applies unchanged
to token serving. It runs on the card unless ``--device cpu`` is given.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch relic_tiny \
      --batch 4 --prompt-len 16 --gen 32
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.devices import resolve_device, synchronize
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model
from repro_torch.serve import ServeScheduler


def load_model(arch: str, *, smoke: bool, device: torch.device):
    """(cfg, model, params) in the serving layout; weights from seed 0."""
    cfg = get_config(arch, smoke=smoke).replace(param_dtype="bfloat16")
    model = build_model(cfg, device)
    params = model.init(torch.Generator().manual_seed(0))
    return cfg, model, params


def make_prompts(cfg, batch: int, prompt_len: int, device, seed: int = 0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
                           device=device)


def decode_stream(serve_step, params, first_tok, cache, start: int, n: int,
                  device: torch.device, steps_timed=None):
    """Generator of ``n`` tokens: the prefill prediction ``first_tok``, then
    one greedy decode step per token from position ``start``."""
    tok = first_tok
    yield tok
    for t in range(start, start + n - 1):
        tok, _, cache = serve_step(params, cache, tok, t)
        if steps_timed is not None:
            steps_timed[0] += 1
        yield tok
    synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="relic_tiny")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--lanes", type=int, default=1,
                    help="RelicPool lanes backing the request server")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' only when asked for")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, model, params = load_model(args.arch, smoke=args.smoke, device=device)
    cache_len = args.prompt_len + args.gen
    cache = model.init_cache(args.batch, cache_len)
    serve_step = make_serve_step(model)
    prefill = make_prefill_step(model)
    prompts = make_prompts(cfg, args.batch, args.prompt_len, device)

    # Warm decode off the served path (its own throwaway cache), so the
    # served request measures steady-state steps, not first-call set-up.
    warm_cache = model.init_cache(args.batch, cache_len)
    warm_tok = torch.zeros((args.batch, 1), dtype=torch.long, device=device)
    serve_step(params, warm_cache, warm_tok, 0)
    synchronize(device)

    tok, cache = prefill(params, cache, prompts)
    synchronize(device)

    steps_timed = [0]  # decode-loop accounting, asserted against gen below
    with ServeScheduler(lanes=args.lanes) as server:
        client = server.open_client("decode")
        resp = client.submit(decode_stream, serve_step, params, tok, cache,
                             args.prompt_len, args.gen, device, steps_timed)
        out = resp.result()

    # Token accounting must match the timed step count: one prefill
    # prediction + one token per timed decode step.
    assert steps_timed[0] == args.gen - 1, (steps_timed[0], args.gen)
    assert len(out) == 1 + steps_timed[0], (len(out), steps_timed[0])

    gen_toks = torch.cat(out, dim=1)
    assert resp.first_result_t is not None and resp.complete_t is not None
    ttft = resp.first_result_t - resp.request.arrival_t
    dt = max(resp.complete_t - resp.first_result_t, 1e-9)
    tps = args.batch * (args.gen - 1) / dt
    print(f"generated {tuple(gen_toks.shape)} tokens on {device}; "
          f"{tps:.1f} tok/s ({dt / max(args.gen - 1, 1) * 1e3:.1f} ms/step, "
          f"ttft {ttft * 1e3:.1f} ms, lanes {args.lanes})")
    print("sample row:", gen_toks[0][:16].cpu().numpy())
    return gen_toks


if __name__ == "__main__":
    main()
