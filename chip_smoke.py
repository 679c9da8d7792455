#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
  2. hold each kernel against its plain-torch version on the card and time
     the kernel, the plain version and one PyTorch library call;
  3. serve relic_tiny at full width (12 layers, d_model 768) through
     ``repro_torch.launch.serve.main`` plus three more requests through one
     ``ServeScheduler``;
  4. run the teacher-forced forward over the served tokens with
     ``use_kernels=True`` and check it against the plain forward and the
     served tokens (phases 3-4 are the main path whose launches are counted);
  5. a long forward and loss at [4, 2048] with the kernel against the plain
     (chunked-attention) path.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it holds the card's name and power limit and the one before that
the kernels' numbers. Without a card it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models.lm import lm_forward, lm_loss  # noqa: E402
from repro_torch.serve import ServeScheduler  # noqa: E402

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores and HBM3 rate.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_S = 3.35e12
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}   # tests/test_kernels.py:70-71
REL_TOL = 1e-2   # ||kernel - plain|| / ||plain||: a dropped kv tile fails it
MODEL_TOL = 0.15                                     # tests/test_models.py:117-119
ARCH = "relic_tiny"
SERVE_BATCH, PROMPT_LEN, GEN = 8, 128, 64
KERNEL_SHAPES = [  # (b, s, h, kv, d): tests/test_kernels.py:55-60
    (2, 128, 4, 4, 32),     # MHA
    (1, 256, 8, 2, 64),     # GQA 4:1
    (2, 128, 8, 1, 32),     # MQA
    (1, 96, 4, 2, 16),      # ragged S
]
MAIN_SHAPE = (4, 2048, 12, 4, 64)  # relic_tiny's attention in the long forward
# relic_tiny's attention in the teacher-forced forward of the counted main path
TEACHER_SHAPE = (SERVE_BATCH, PROMPT_LEN + GEN, 12, 4, 64)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(q, k, v, causal: bool):
    """Least time for the attention function on these inputs: the larger of
    bytes (q, k, v read once, o written once) over the memory rate and the
    two products' operations (only the (i, j) pairs the mask keeps) over the
    peak rate for the input type."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    flops = 4 * b * h * d * pairs
    nbytes = 2 * q.nbytes + k.nbytes + v.nbytes
    t_ops = flops / PEAK_FLOPS[q.dtype]
    t_bytes = nbytes / PEAK_BYTES_S
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, bound_by, flops, nbytes


def device_profile(fn, label: str):
    """Run ``fn`` once under torch.profiler and print its wall time, the
    card's busy time (the union of its kernel and copy intervals) and the
    costliest kernels. The profiler's own cost inflates the wall time."""
    from torch.profiler import ProfilerActivity, profile

    trace = os.path.join(ROOT, "build", "chip_smoke_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    device_events = [e for e in events if "dur" in e and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    if not device_events:
        print(f"[profile] {label}: wall {wall_ms:.2f} ms; device time not "
              f"measured (the profiler recorded no kernels)")
        return
    busy, end = 0.0, float("-inf")
    for ts, te in sorted((e["ts"], e["ts"] + e["dur"]) for e in device_events):
        busy += max(0.0, te - max(ts, end))
        end = max(end, te)
    by_name: dict[str, float] = {}
    for e in device_events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile] {label}: wall {wall_ms:.2f} ms under the profiler, card "
          f"busy {busy / 1e3:.2f} ms ({busy / 1e3 / wall_ms:.1%}, idle "
          f"{1 - busy / 1e3 / wall_ms:.1%}), {len(device_events)} device ops")
    for name, us in top:
        print(f"[profile]   {us / 1e3:8.3f} ms  {name[:90]}")


def phase_build():
    t0 = time.perf_counter()
    path = _build.build("flash_attention")
    print(f"[build] flash_attention.cu -> {os.path.relpath(path, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")
    log = path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}")


def _qkv(gen, b, s, h, kv, d, dtype, device):
    def mk(heads):
        x = torch.randn((b, heads, s, d), generator=gen, dtype=torch.float32)
        return x.to(device=device, dtype=dtype)
    return mk(h), mk(kv), mk(kv)


def check_kernel(gen, b, s, h, kv, d, dtype, causal, device):
    """The kernel against its plain version on one seeded input: elementwise
    at the test tolerance and in relative norm. Returns the inputs and the
    largest absolute difference."""
    q, k, v = _qkv(gen, b, s, h, kv, d, dtype, device)
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    diff = got.float() - want.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / want.float().norm()).item()
    print(f"[kernel] b{b} s{s} h{h} kv{kv} d{d} {str(dtype)[6:]} "
          f"causal={causal}: max|err| {err:.3g} (tol {TOL[dtype]}), "
          f"relative {rel:.3g} (tol {REL_TOL})")
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    if not rel < REL_TOL:
        raise AssertionError(f"relative error {rel} >= {REL_TOL}")
    return (q, k, v), err


def phase_kernel(device):
    gen = torch.Generator().manual_seed(0)
    for b, s, h, kv, d in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                check_kernel(gen, b, s, h, kv, d, dtype, causal, device)

    dtype = torch.bfloat16
    (q, k, v), _ = check_kernel(gen, *TEACHER_SHAPE, dtype, True, device)
    ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True), 50)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True), 50)
    bound_ms, bound_by, _, _ = attention_bound_ms(q, k, v, True)
    print(f"[kernel] teacher-forced shape q{list(q.shape)} kv{list(k.shape)} "
          f"bf16 causal: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms by {bound_by}")

    (q, k, v), max_err = check_kernel(gen, *MAIN_SHAPE, dtype, True, device)
    b, s, h, kv, d = MAIN_SHAPE
    # The library yardstick: one SDPA call on the same function (kv heads
    # repeated beforehand, outside the timed call). The port never calls it.
    k_rep = torch.repeat_interleave(k, h // kv, dim=1)
    v_rep = torch.repeat_interleave(v, h // kv, dim=1)
    ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True), 20)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True), 10)
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k_rep, v_rep, is_causal=True), 20)
    bound_ms, bound_by, flops, nbytes = attention_bound_ms(q, k, v, True)
    print(f"[kernel] main shape q{list(q.shape)} kv{list(k.shape)} bf16 causal: "
          f"max|err| {max_err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
          f" sdpa {library_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
          f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); "
          f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:27",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "shape": f"q{list(q.shape)} kv{list(k.shape)} bf16 causal"}


def phase_serve(device):
    argv = ["--arch", ARCH, "--batch", str(SERVE_BATCH), "--prompt-len",
            str(PROMPT_LEN), "--gen", str(GEN), "--device", device.type]
    t0 = time.perf_counter()
    gen_toks = serve.main(argv)
    print(f"[serve] main({' '.join(argv)}) took {time.perf_counter() - t0:.1f} s")
    if tuple(gen_toks.shape) != (SERVE_BATCH, GEN):
        raise AssertionError(f"served shape {tuple(gen_toks.shape)}")

    # The served weights again (the same seed), then three more requests
    # through one scheduler, each prefilling inside its work function so its
    # TTFT covers the prefill.
    cfg, model, params = serve.load_model(ARCH, smoke=False, device=device)
    serve_step, prefill = make_serve_step(model), make_prefill_step(model)
    n_req, plen, ngen = 3, 32, 16

    def request(prompts):
        cache = model.init_cache(prompts.shape[0], plen + ngen)
        tok, cache = prefill(params, cache, prompts)
        yield from serve.decode_stream(serve_step, params, tok, cache, plen,
                                       ngen, device)

    with ServeScheduler(lanes=1) as server:
        client = server.open_client("smoke")
        resps = [client.submit(request, serve.make_prompts(
            cfg, SERVE_BATCH, plen, device, seed=1 + i)) for i in range(n_req)]
        outs = [r.result() for r in resps]
    for i, (r, out) in enumerate(zip(resps, outs)):
        toks = torch.cat(out, dim=1)
        if tuple(toks.shape) != (SERVE_BATCH, ngen):
            raise AssertionError(f"request {i}: shape {tuple(toks.shape)}")
        ttft = r.first_result_t - r.request.arrival_t
        dt = r.complete_t - r.first_result_t
        print(f"[serve] request {i + 1}: {tuple(toks.shape)} tokens, ttft "
              f"{ttft * 1e3:.1f} ms, {SERVE_BATCH * (ngen - 1) / dt:.1f} tok/s "
              f"({dt / (ngen - 1) * 1e3:.2f} ms/step)")
    print(f"[serve] {1 + n_req} requests served at full width")

    # The same decode step outside the scheduler: what the served ms/step
    # would be without the runtime's threads, and where the step's time goes.
    n_steps = 16

    def decode():
        cache = model.init_cache(SERVE_BATCH, PROMPT_LEN + n_steps)
        tok = torch.zeros((SERVE_BATCH, 1), dtype=torch.long, device=device)
        for t in range(PROMPT_LEN, PROMPT_LEN + n_steps):
            tok, _, cache = serve_step(params, cache, tok, t)

    decode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode()
    torch.cuda.synchronize()
    print(f"[serve] decode step outside the scheduler, batch {SERVE_BATCH}: "
          f"{(time.perf_counter() - t0) / n_steps * 1e3:.2f} ms/step")
    device_profile(decode, f"{n_steps} decode steps, batch {SERVE_BATCH}")
    return cfg, params, gen_toks


@torch.no_grad()
def phase_forward(cfg, params, gen_toks, device):
    prompts = serve.make_prompts(cfg, SERVE_BATCH, PROMPT_LEN, device)
    tokens = torch.cat([prompts, gen_toks], dim=1)       # [8, 192]
    before = fa.launches
    logits_k, _ = lm_forward(cfg.replace(use_kernels=True), params, tokens)
    torch.cuda.synchronize()
    n = fa.launches - before
    if n != cfg.n_layers:
        raise AssertionError(f"kernel launched {n} times, want {cfg.n_layers}")
    logits_p, _ = lm_forward(cfg, params, tokens)
    err = (logits_k - logits_p).abs().max().item()
    torch.testing.assert_close(logits_k, logits_p, rtol=MODEL_TOL, atol=MODEL_TOL)
    # position P-1+j predicts served token j
    pred = logits_k[:, PROMPT_LEN - 1:PROMPT_LEN - 1 + GEN].argmax(-1)
    agree = (pred == gen_toks).float().mean().item()
    print(f"[forward] tokens {list(tokens.shape)}: {n} kernel launches, "
          f"max|logits kernel - plain| {err:.3g} (tol {MODEL_TOL}), greedy "
          f"agreement with served tokens {agree:.4f}")
    if not agree > 0.9:
        raise AssertionError(f"greedy agreement {agree} <= 0.9")


@torch.no_grad()
def phase_long(cfg, params, device):
    b, s = MAIN_SHAPE[0], MAIN_SHAPE[1]
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s + 1)),
                           device=device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": torch.ones((b, s), device=device)}
    cfg_k = cfg.replace(use_kernels=True)
    before = fa.launches
    loss, _ = lm_loss(cfg_k, params, batch)
    if not torch.isfinite(loss):
        raise AssertionError(f"loss {loss.item()}")
    if fa.launches - before != cfg.n_layers:
        raise AssertionError(f"{fa.launches - before} launches in the loss")

    def timed(c):
        lm_forward(c, params, batch["tokens"])  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = lm_forward(c, params, batch["tokens"])
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    logits_k, ms_k = timed(cfg_k)
    logits_p, ms_p = timed(cfg)
    err = (logits_k - logits_p).abs().max().item()
    torch.testing.assert_close(logits_k, logits_p, rtol=MODEL_TOL, atol=MODEL_TOL)
    print(f"[long] tokens [{b}, {s}]: loss {loss.item():.4f}; forward with "
          f"kernel {ms_k:.2f} ms, plain (chunked attention) {ms_p:.2f} ms; "
          f"max|logits diff| {err:.3g} (tol {MODEL_TOL})")
    device_profile(lambda: lm_forward(cfg_k, params, batch["tokens"]),
                   f"forward [{b}, {s}] with the kernel")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, cuda {torch.version.cuda}")

    phase_build()
    entry = phase_kernel(device)

    fa.launches = 0                       # the main path: serve + forward
    cfg, params, gen_toks = phase_serve(device)
    phase_forward(cfg, params, gen_toks, device)
    entry["launches"] = fa.launches
    if entry["launches"] != cfg.n_layers:
        raise AssertionError(f"main path launched the kernel "
                             f"{entry['launches']} times, want {cfg.n_layers}")

    phase_long(cfg, params, device)

    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
