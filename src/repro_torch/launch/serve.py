"""Serving entry point: batched prefill + greedy decode, served as a streaming
request through ``repro_torch.serve.ServeScheduler``.

The decode loop is a *generator* work function — each generated token is
one yielded item, so the subsystem's latency accounting applies unchanged
to token serving. The prefill (and the encoder-decoder's encode) runs
before the request is submitted, so the response's ``first_result_t`` is
only the scheduler's hand-off of a token already computed; the time to the
first token that ``main`` prints adds the encode and the prefill to it. It
runs on the card unless ``--device cpu`` is given.

The encoder-decoder (``--arch whisper_large_v3``) first encodes frames drawn
from the same seeded generator as the prompts and writes each decoder
layer's cross K/V into the cache, as the reference's driver does; the VLM
serves text only, as there.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch relic_tiny \
      --batch 4 --prompt-len 16 --gen 32
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.devices import resolve_device, synchronize
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model
from repro_torch.models.encdec import encode, prefill_cross_cache
from repro_torch.serve import ServeScheduler


def load_model(arch: str, *, smoke: bool, device: torch.device,
               n_layers: Optional[int] = None):
    """(cfg, model, params) in the serving layout; weights from seed 0.
    ``n_layers`` cuts the config's depth (its width stays)."""
    cfg = get_config(arch, smoke=smoke).replace(param_dtype="bfloat16")
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = build_model(cfg, device)
    params = model.init(torch.Generator().manual_seed(0))
    return cfg, model, params


def make_prompts(cfg, batch: int, prompt_len: int, device, seed: int = 0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
                           device=device)


def make_frames(cfg, batch: int, prompt_len: int, device, seed: int = 0):
    """The encoder-decoder's frames [B, T_enc, D] in bf16: the draw after
    ``make_prompts``' from the same seeded generator, as the reference's
    driver draws them."""
    rng = np.random.default_rng(seed)
    rng.integers(0, cfg.vocab_size, (batch, prompt_len))  # the prompts' draw
    frames = rng.normal(size=(batch, cfg.frontend.n_tokens, cfg.d_model))
    return torch.as_tensor(frames, dtype=torch.float32).to(
        device=device, dtype=torch.bfloat16)


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


def parse_args(argv=None) -> argparse.Namespace:
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
    return ap.parse_args(argv)


def run(args: argparse.Namespace, cfg, model, params, device: torch.device):
    """Serve one request of ``args.batch`` prompts on loaded weights.

    Returns the generated tokens [batch, gen] and the host-clock times in
    ms: ``encode_ms`` (the encoder-decoder's encode and cross-cache write;
    nothing runs there for the other families), ``prefill_ms``, ``handoff_ms`` (from the
    request's submission to its first token, which the prefill has already
    computed: the scheduler's hand-off, the reference's "ttft"), ``ttft_ms``
    (the three together: what a user waits for the first token) and
    ``ms_per_step`` (the decode steps inside the scheduler)."""
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

    t0 = time.perf_counter()
    if cfg.family == "encdec":
        frames = make_frames(cfg, args.batch, args.prompt_len, device)
        with torch.no_grad():
            cache = prefill_cross_cache(cfg, params, cache,
                                        encode(cfg, params, frames))
        synchronize(device)
    t1 = time.perf_counter()
    tok, cache = prefill(params, cache, prompts)
    synchronize(device)
    t2 = time.perf_counter()

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
    assert resp.first_result_t is not None and resp.complete_t is not None
    handoff = resp.first_result_t - resp.request.arrival_t
    dt = max(resp.complete_t - resp.first_result_t, 1e-9)
    stats = {"encode_ms": (t1 - t0) * 1e3, "prefill_ms": (t2 - t1) * 1e3,
             "handoff_ms": handoff * 1e3,
             "ttft_ms": (t2 - t0 + handoff) * 1e3,
             "ms_per_step": dt / max(args.gen - 1, 1) * 1e3,
             "tok_s": args.batch * (args.gen - 1) / dt}
    return torch.cat(out, dim=1), stats


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg, model, params = load_model(args.arch, smoke=args.smoke, device=device)
    gen_toks, st = run(args, cfg, model, params, device)
    encode_part = (f"encode {st['encode_ms']:.1f} ms, "
                   if cfg.family == "encdec" else "")
    print(f"generated {tuple(gen_toks.shape)} tokens on {device}; "
          f"{st['tok_s']:.1f} tok/s ({st['ms_per_step']:.1f} ms/step, ttft "
          f"{st['ttft_ms']:.1f} ms: {encode_part}prefill {st['prefill_ms']:.1f} "
          f"ms, hand-off {st['handoff_ms']:.1f} ms; lanes {args.lanes})")
    print("sample row:", gen_toks[0][:16].cpu().numpy())
    return gen_toks


if __name__ == "__main__":
    main()
