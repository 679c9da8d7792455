#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
     one compiler per source, all started together;
  2. hold each kernel against its plain-torch version on the card (test
     shapes, a ragged length, the main paths' shapes and a long one) and
     time the kernel, the plain version and, where one exists, one PyTorch
     library call; check that ``ops.flash_attention`` and ``ops.matmul``
     launch their kernels at shapes no multiple of the TPU tiles;
  3. serve relic_tiny at full width (12 layers, d_model 768) through
     ``repro_torch.launch.serve.main`` plus three more requests through one
     ``ServeScheduler``;
  4. run the teacher-forced forward over the served tokens with
     ``use_kernels=True`` and check it against the plain forward and the
     served tokens;
  5. serve rwkv6_1p6b (24 layers, d_model 2048) and run its teacher-forced
     forward through the wkv6 kernel, the same way;
  6. serve zamba2_1p2b (38 Mamba-2 layers and 6 applications of the shared
     attention block, d_model 2048) and run its teacher-forced forward
     through the ssd and flash-attention kernels, the same way;
  7. the quickstart path, ``repro_torch.quickstart.main`` at full width: the
     tasking façade, one train step, eight decode steps and one
     ``ops.matmul`` through the relic_matmul kernel;
  8. training relic_tiny at full width (f32 parameters, bf16 compute):
     grad_accum 2 against 1, then 20 steps on one batch with the loss
     falling; then one f32 train step at SMOKE size on the card against the
     same step on the CPU;
  9. a long relic_tiny forward and loss at [4, 2048] with the kernel against
     the plain (chunked-attention) path.
Phases 3-4, 5, 6 and 7 are the main paths: each starts with every kernel's
launch count at 0 and its counts are read when it ends; phase 8 must launch
no kernel (training runs the plain paths, as the reference's does).

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it holds the card's name and power limit and the one before that
the kernels' numbers. Without a card it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import quickstart  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import relic_matmul as rm  # noqa: E402
from repro_torch.kernels import ssd as ssd_k  # noqa: E402
from repro_torch.kernels import wkv6 as wkv6_k  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,  # noqa: E402
                                      make_train_state, make_train_step)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import mamba2 as m2  # noqa: E402
from repro_torch.models import rwkv6 as r6  # noqa: E402
from repro_torch.models.convert import (train_state_from_numpy,  # noqa: E402
                                        train_state_to_numpy)
from repro_torch.models.lm import lm_forward, lm_loss  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
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
# zamba2_1p2b's shared attention in its teacher-forced forward (no GQA)
ZAMBA_ATTN_SHAPE = (SERVE_BATCH, PROMPT_LEN + 128, 32, 32, 64)
# Each kernel's launch counter: name -> (module, attribute).
COUNTERS = {"flash_attention": (fa, "launches"), "wkv6": (wkv6_k, "launches"),
            "ssd": (ssd_k, "launches"), "relic_matmul": (rm, "launches"),
            "relic_matmul_gated": (rm, "gated_launches")}
SOURCES = ["flash_attention", "relic_matmul", "ssd", "wkv6"]   # csrc/<name>.cu
# The recurrent kernels: f32 1e-3, bf16 rtol 2e-2 / atol 2e-1
# (tests/test_kernels.py:88-93,108-111).
REC_TOL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (2e-2, 2e-1)}
# wkv6 shapes (b, h, t, k, chunk): tests/test_kernels.py:75-79, a ragged
# length, the served rwkv6_1p6b forward [8, 192] and a long one.
WKV6_TEST_SHAPES = [(2, 2, 64, 16, 16), (1, 4, 128, 32, 32), (2, 2, 96, 16, 32),
                    (2, 4, 96, 64, 64)]
WKV6_SERVED = (SERVE_BATCH, 32, PROMPT_LEN + 64, 64, 64)
WKV6_LONG = (4, 32, 2048, 64, 64)
# ssd shapes (b, h, t, p, n, chunk): tests/test_kernels.py:97-100, a ragged
# length, the served zamba2_1p2b forward [8, 256] and a long one.
SSD_TEST_SHAPES = [(2, 2, 64, 16, 8, 16), (1, 4, 128, 32, 16, 32),
                   (2, 4, 200, 64, 64, 128)]
SSD_SERVED = (SERVE_BATCH, 64, PROMPT_LEN + 128, 64, 64, 128)
SSD_LONG = (4, 64, 2048, 64, 64, 128)
# The main paths: (arch, generated tokens, kernel launches of the path,
# whether its bf16 forward holds the bars of tests/test_models.py:117-123).
# The recurrent families with random weights at full depth do not: their
# forwards amplify rounding differences (on an H100, rwkv6_1p6b's bf16 plain
# forward lies 0.39 in relative norm from its f32 one and agrees with the
# served tokens on 62%; zamba2_1p2b's plain forward agrees on 92%), so each
# is held to its own rounding noise, and each layer's kernel call to the
# model's plain chunked form on the same inputs (check_layers).
MAIN_PATHS = [(ARCH, GEN, {"flash_attention": 12}, True),
              ("rwkv6_1p6b", 64, {"wkv6": 24}, False),
              ("zamba2_1p2b", 128, {"ssd": 38, "flash_attention": 6}, False)]
QUICKSTART_LAUNCHES = {"relic_matmul": 1}   # its ops.matmul (quickstart.py)
# relic_matmul: f32 rtol 2e-4 / atol 1e-2 (tests/test_kernels.py:35-37); bf16
# rtol 2e-2 / atol 2e-1, tighter than the tests' 2e-1 / 10. The gated form:
# rtol 2e-2, atol 2e-2 in f32 and 2.0 in bf16 (tests/test_kernels.py:48-50).
MM_TOL = {torch.float32: (2e-4, 1e-2), torch.bfloat16: (2e-2, 2e-1)}
GATED_TOL = {torch.float32: (2e-2, 2e-2), torch.bfloat16: (2e-2, 2.0)}
# (m, n, k) of x [m, k] @ w [k, n]: tests/test_kernels.py:24-29, the last ragged.
MM_TEST_SHAPES = [(128, 128, 128), (256, 384, 512), (512, 256, 1024), (100, 60, 36)]
# Timed: (label, m, n, k, dtype, iterations). The quickstart's product (its
# main path, examples/quickstart.py:64-66), relic_tiny's MLP products at the
# train phase's 2048 tokens, and a square one.
MM_TIMED = [("quickstart", 128, 128, 256, torch.float32, 50),
            ("relic_tiny mlp gate/up", 2048, 2048, 768, torch.bfloat16, 50),
            ("relic_tiny mlp down", 2048, 768, 2048, torch.bfloat16, 50),
            ("square", 4096, 4096, 4096, torch.bfloat16, 20),
            ("square", 4096, 4096, 4096, torch.float32, 5)]
GATED_TEST = (256, 128, 256)    # tests/test_kernels.py:42-46
GATED_MLP = (2048, 2048, 768)   # relic_tiny's act(x@Wg)*(x@Wu) at 2048 tokens
# Training (launch/train.py:35-36,54-55): batch 8 x 256 tokens, 20 steps.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 20
TRAIN_OC = OptConfig(peak_lr=3e-4, warmup_steps=max(TRAIN_STEPS // 20, 5),
                     total_steps=TRAIN_STEPS)


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


def _chunks(t: int, chunk: int):
    """Lengths of the chunks the chunked algorithm cuts T into."""
    return [min(chunk, t - t0) for t0 in range(0, t, chunk)]


def _bound(flops: float, exps: float, nbytes: float):
    """max(operations / f32 peak, bytes / memory rate). Both recurrences
    compute in f32 (the TPU kernels cast every block to f32), so their
    operations, exponentials included, count against the f32 rate."""
    t_ops = (flops + exps) / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / PEAK_BYTES_S
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, bound_by


def wkv6_bound_ms(r, logw, u, chunk: int):
    """Least time for wkv6 on these inputs, counting the chunked algorithm's
    work per (b, h) and chunk of c steps over K channels: the strictly causal
    pairwise term (c(c-1)/2 * K exponentials, 4 operations each pair and
    channel), the diagonal bonus, scores @ v, r_dec @ state, the state
    update and the rescalings; bytes are r, k, v, logw, u read once and out
    written once. Returns (ms, bound_by, flops, exps, bytes)."""
    b, h, t, kk = r.shape
    flops = exps = 0
    for c in _chunks(t, chunk):
        pairs = c * (c - 1) // 2
        exps += pairs * kk + 2 * c * kk + kk
        flops += (4 * pairs * kk + 3 * c * kk + c * (c + 1) * kk
                  + 4 * c * kk * kk + 4 * c * kk + 2 * kk * kk)
    flops, exps = flops * b * h, exps * b * h
    nbytes = 4 * r.nbytes + logw.nbytes + u.nbytes
    ms, bound_by = _bound(flops, exps, nbytes)
    return ms, bound_by, flops, exps, nbytes


def ssd_bound_ms(x, a, bmat, chunk: int):
    """Least time for ssd on these inputs, counting the chunked algorithm's
    work per chunk of c steps: C B^T once per batch row (the heads share
    it), and per head the decay of the c(c+1)/2 kept pairs (one
    exponential each), W @ x, C @ state^T, the state update and the
    rescalings; bytes are x, a, b, c read once and y written once.
    Returns (ms, bound_by, flops, exps, bytes)."""
    bb, h, t, p = x.shape
    n = bmat.shape[-1]
    flops = exps = 0
    for c in _chunks(t, chunk):
        pairs = c * (c + 1) // 2
        flops += bb * 2 * pairs * n
        exps += bb * h * (pairs + 2 * c + 1)
        flops += bb * h * (2 * pairs + 2 * pairs * p + 4 * c * n * p
                           + 3 * c * p + 2 * c + 2 * p * n)
    nbytes = 2 * x.nbytes + a.nbytes + 2 * bmat.nbytes
    ms, bound_by = _bound(flops, exps, nbytes)
    return ms, bound_by, flops, exps, nbytes


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
    """Compile every kernel source at once (one nvcc each) and print each
    compiler's register and spill report."""
    names = SOURCES
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(_build.build, names)))
    print(f"[build] {len(names)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        print(f"[build] {name}.cu -> {os.path.relpath(path, ROOT)}")
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

    (q, k, v), _ = check_kernel(gen, *ZAMBA_ATTN_SHAPE, dtype, True, device)
    ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True), 50)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True), 50)
    bound_ms, bound_by, _, _ = attention_bound_ms(q, k, v, True)
    print(f"[kernel] zamba2 shared-attention shape q{list(q.shape)} "
          f"kv{list(k.shape)} bf16 causal: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by}")

    # ops.flash_attention keeps no tile predicate: lengths that are no
    # multiple of any tile go to the kernel too.
    for s in (96, 300):
        q, k, v = _qkv(gen, 1, s, 4, 2, 64, dtype, device)
        before = fa.launches
        got = ops.flash_attention(*(x.transpose(1, 2) for x in (q, k, v)),
                                  causal=True).transpose(1, 2)
        if fa.launches != before + 1:
            raise AssertionError(f"ops.flash_attention at S={s} launched the "
                                 f"kernel {fa.launches - before} times")
        want = fa.flash_attention_plain(q, k, v, causal=True)
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])
        print(f"[kernel] ops.flash_attention at S={s} launched the kernel")

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


def _hold(name, got, want, rtol, atol):
    """A kernel's output against its plain version: finite, elementwise at
    the test tolerance and in relative norm. Returns the largest absolute
    difference."""
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    diff = got.float() - want.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / want.float().norm()).item()
    print(f"[kernel] {name} {str(got.dtype)[6:]}: max|err| {err:.3g} (rtol "
          f"{rtol}, atol {atol}), relative {rel:.3g} (tol {REL_TOL})")
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    if not rel < REL_TOL:
        raise AssertionError(f"{name}: relative error {rel} >= {REL_TOL}")
    return err


def _wkv6_inputs(gen, b, h, t, k, dtype, device):
    """Seeded inputs with the aggressive decays of tests/test_kernels.py:84."""
    def mk(*shape):
        return torch.randn(shape, generator=gen)
    r, kk, v = (mk(b, h, t, k).to(device=device, dtype=dtype) for _ in range(3))
    logw = (-torch.exp(mk(b, h, t, k))).to(device)
    return r, kk, v, logw, mk(h, k).to(device)


def _ssd_inputs(gen, b, h, t, p, n, dtype, device):
    def mk(*shape):
        return torch.randn(shape, generator=gen)
    x = mk(b, h, t, p).to(device=device, dtype=dtype)
    a = (-mk(b, h, t).abs() * 0.5).to(device)
    return x, a, mk(b, t, n).to(device), mk(b, t, n).to(device)


def phase_recurrence(name, mod, replaces, make_inputs, bound, test_shapes,
                     served, long_, main_dtype, seed, device):
    """Hold a recurrent kernel (``mod``: wkv6 or ssd) against its plain
    version at the test shapes in f32 and bf16, then at the served path's
    shape and a long one in ``main_dtype``, timing kernel and plain version
    there. Shapes end with the chunk length. Returns the kernel's entry of
    the numbers line (its numbers at the served shape)."""
    cuda_fn, plain_fn = getattr(mod, f"{name}_cuda"), getattr(mod, f"{name}_plain")
    gen = torch.Generator().manual_seed(seed)
    for *shape, chunk in test_shapes:
        for dtype in (torch.float32, torch.bfloat16):
            ins = make_inputs(gen, *shape, dtype, device)
            _hold(f"{name} {shape} chunk {chunk}", cuda_fn(*ins, chunk=chunk),
                  plain_fn(*ins), *REC_TOL[dtype])
    timed = {}
    for label, (*shape, chunk), iters in (("served", served, 20),
                                          ("long", long_, 3)):
        ins = make_inputs(gen, *shape, main_dtype, device)
        err = _hold(f"{name} {shape} chunk {chunk} ({label})",
                    cuda_fn(*ins, chunk=chunk), plain_fn(*ins),
                    *REC_TOL[main_dtype])
        ms = time_ms(lambda: cuda_fn(*ins, chunk=chunk), iters)
        plain_ms = time_ms(lambda: plain_fn(*ins), iters, warmup=1)
        bound_ms, bound_by, flops, exps, nbytes = bound(ins, chunk)
        desc = f"{shape} {str(main_dtype)[6:]} chunk {chunk}"
        print(f"[kernel] {name} {label} shape {desc}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by}")
        print(f"[kernel]   {name} {label}: {flops / 1e9:.3f} GFLOP of f32 "
              f"arithmetic, {nbytes / 1e6:.2f} MB; "
              f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
        print(f"[kernel]   {name} {label}: {exps / 1e9:.4f} G exponentials")
        timed[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by, shape=desc)
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": None, **timed["served"],
            "library_ms": None, "long": timed["long"]}


def matmul_bound_ms(m, n, k, dtype, n_weights=1):
    """Least time for x [m, k] times ``n_weights`` weights [k, n] (the gated
    form has two): the larger of 2mnk operations per weight over the peak
    rate for the input type and the bytes of x, the weights and the output
    (each read or written once) over the memory rate. Returns (ms,
    bound_by, flops, bytes)."""
    size = torch.finfo(dtype).bits // 8
    flops = 2 * m * n * k * n_weights
    nbytes = size * (m * k + n_weights * k * n + m * n)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_S
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, bound_by, flops, nbytes


def _mm_inputs(gen, m, n, k, dtype, n_weights, device):
    def mk(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    return mk(m, k), [mk(k, n) for _ in range(n_weights)]


def _mm_label(name, m, n, k, act=None):
    return f"{name} [{m}, {k}] @ [{k}, {n}]" + (f" act={act}" if act else "")


def phase_matmul(device):
    """relic_matmul and relic_matmul_gated against their plain versions on
    the card: the test shapes in f32 and bf16 (one ragged), the gated form
    with silu, gelu and an unknown name (no activation), then timing at the
    quickstart's shape, relic_tiny's MLP shapes and a square one beside the
    bound, the plain version and torch.matmul. Returns the two kernels'
    entries of the numbers line (relic_matmul's at the quickstart's shape,
    the gated form's at relic_tiny's MLP shape)."""
    gen = torch.Generator(device=device).manual_seed(3)
    for m, n, k in MM_TEST_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, (w,) = _mm_inputs(gen, m, n, k, dtype, 1, device)
            _hold(_mm_label("relic_matmul", m, n, k),
                  rm.relic_matmul_cuda(x, w), rm.relic_matmul_plain(x, w),
                  *MM_TOL[dtype])
    m, n, k = GATED_TEST
    for act in ("silu", "gelu", "none"):
        for dtype in (torch.float32, torch.bfloat16):
            x, (wg, wu) = _mm_inputs(gen, m, n, k, dtype, 2, device)
            _hold(_mm_label("relic_matmul_gated", m, n, k, act),
                  rm.relic_matmul_gated_cuda(x, wg, wu, act=act),
                  rm.relic_matmul_gated_plain(x, wg, wu, act), *GATED_TOL[dtype])

    # ops.matmul keeps no tile predicate: a ragged shape goes to the kernel.
    x, (w,) = _mm_inputs(gen, 100, 60, 36, torch.float32, 1, device)
    before = rm.launches
    got = ops.matmul(x, w, bm=128, bn=128, bk=128)
    if rm.launches != before + 1:
        raise AssertionError(f"ops.matmul at [100, 36] @ [36, 60] launched the "
                             f"kernel {rm.launches - before} times")
    _hold("ops.matmul [100, 36] @ [36, 60]", got, rm.relic_matmul_plain(x, w),
          *MM_TOL[torch.float32])

    timed = []
    for label, m, n, k, dtype, iters in MM_TIMED:
        x, (w,) = _mm_inputs(gen, m, n, k, dtype, 1, device)
        desc = f"{_mm_label(label, m, n, k)} {str(dtype)[6:]}"
        err = _hold(_mm_label(label, m, n, k), rm.relic_matmul_cuda(x, w),
                    rm.relic_matmul_plain(x, w), *MM_TOL[dtype])
        ms = time_ms(lambda: rm.relic_matmul_cuda(x, w), iters)
        plain_ms = time_ms(lambda: rm.relic_matmul_plain(x, w), iters)
        # The library yardstick: torch.matmul in the input type (cuBLAS; TF32
        # is off, so f32 stays f32). The port never calls it.
        library_ms = time_ms(lambda: torch.matmul(x, w), iters)
        bound_ms, bound_by, flops, nbytes = matmul_bound_ms(m, n, k, dtype)
        print(f"[kernel] {desc}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.matmul {library_ms:.4f} ms; bound {bound_ms:.4f} ms by "
              f"{bound_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); "
              f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
        timed.append(dict(shape=desc, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms))

    m, n, k = GATED_MLP
    dtype = torch.bfloat16
    x, (wg, wu) = _mm_inputs(gen, m, n, k, dtype, 2, device)
    desc = f"{_mm_label('relic_matmul_gated', m, n, k, 'silu')} {str(dtype)[6:]}"
    err = _hold(_mm_label("relic_matmul_gated", m, n, k, "silu"),
                rm.relic_matmul_gated_cuda(x, wg, wu, act="silu"),
                rm.relic_matmul_gated_plain(x, wg, wu, "silu"), *GATED_TOL[dtype])
    ms = time_ms(lambda: rm.relic_matmul_gated_cuda(x, wg, wu, act="silu"), 50)
    plain_ms = time_ms(lambda: rm.relic_matmul_gated_plain(x, wg, wu, "silu"), 50)
    bound_ms, bound_by, flops, nbytes = matmul_bound_ms(m, n, k, dtype, 2)
    print(f"[kernel] {desc}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB); {flops / ms / 1e9:.1f} TFLOP/s achieved")
    source = "src/repro_torch/kernels/csrc/relic_matmul.cu"
    return (
        {"name": "relic_matmul", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/relic_matmul.py:28", "launches": None,
         **timed[0], "other_shapes": timed[1:]},
        {"name": "relic_matmul_gated", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/relic_matmul.py:73", "launches": None,
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
         "shape": desc})


def decode_outside(cfg, model, params, device):
    """The decode step outside the scheduler: what the served ms/step would
    be without the runtime's threads, and where the step's time goes."""
    serve_step = make_serve_step(model)
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
    print(f"[serve] {cfg.name}: decode step outside the scheduler, batch "
          f"{SERVE_BATCH}: {(time.perf_counter() - t0) / n_steps * 1e3:.2f} "
          f"ms/step")
    device_profile(decode, f"{cfg.name}: {n_steps} decode steps, batch "
                           f"{SERVE_BATCH}")


def serve_main(arch, gen, device):
    """``serve.main`` as a user runs it, at full width."""
    argv = ["--arch", arch, "--batch", str(SERVE_BATCH), "--prompt-len",
            str(PROMPT_LEN), "--gen", str(gen), "--device", device.type]
    t0 = time.perf_counter()
    gen_toks = serve.main(argv)
    print(f"[serve] main({' '.join(argv)}) took {time.perf_counter() - t0:.1f} s")
    if tuple(gen_toks.shape) != (SERVE_BATCH, gen):
        raise AssertionError(f"served shape {tuple(gen_toks.shape)}")
    return gen_toks


def phase_serve(device):
    gen_toks = serve_main(ARCH, GEN, device)

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
    decode_outside(cfg, model, params, device)
    return cfg, params, gen_toks


def _launches():
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def _reset_launches():
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def _count_path(label, want, entries):
    """The launches since the last reset must be exactly ``want`` ({kernel:
    count}); they are added to the kernels' entries of the numbers line."""
    got = {n: c for n, c in _launches().items() if c}
    print(f"[main] {label}: kernel launches {got}")
    if got != want:
        raise AssertionError(f"{label} launched {got}, want {want}")
    for name, count in got.items():
        entries[name]["launches"] += count


def _timed_forward(cfg, params, tokens):
    """(logits, ms): one warm call, then one timed on the host clock."""
    lm_forward(cfg, params, tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = lm_forward(cfg, params, tokens)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _rel(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def _agree(logits_a, logits_b) -> float:
    return (logits_a.argmax(-1) == logits_b.argmax(-1)).float().mean().item()


@torch.no_grad()
def phase_forward(cfg, params, gen_toks, want, bf16_bar, device):
    """The teacher-forced forward over prompt plus served tokens with the
    kernels (bf16, as served): exactly ``want`` launches ({kernel: count});
    where ``bf16_bar``, logits within MODEL_TOL of the plain forward and
    greedy agreement with the served tokens above 0.9. Returns (tokens,
    kernel logits, plain logits)."""
    gen = gen_toks.shape[1]
    prompts = serve.make_prompts(cfg, SERVE_BATCH, PROMPT_LEN, device)
    tokens = torch.cat([prompts, gen_toks], dim=1)
    cfg_k = cfg.replace(use_kernels=True)
    before = _launches()
    logits_k, _ = lm_forward(cfg_k, params, tokens)
    torch.cuda.synchronize()
    got = {n: c - before[n] for n, c in _launches().items() if c != before[n]}
    if got != want:
        raise AssertionError(f"{cfg.name}: kernel launches {got}, want {want}")
    logits_p, _ = lm_forward(cfg, params, tokens)
    if not (torch.isfinite(logits_k).all() and torch.isfinite(logits_p).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    err = (logits_k - logits_p).abs().max().item()
    # position P-1+j predicts served token j
    served = slice(PROMPT_LEN - 1, PROMPT_LEN - 1 + gen)
    agree = (logits_k[:, served].argmax(-1) == gen_toks).float().mean().item()
    agree_p = (logits_p[:, served].argmax(-1) == gen_toks).float().mean().item()
    print(f"[forward] {cfg.name} tokens {list(tokens.shape)} bf16: launches "
          f"{got}, max|logits kernel - plain| {err:.3g}, relative "
          f"{_rel(logits_k, logits_p):.3g}, greedy agreement with served "
          f"tokens {agree:.4f} (plain forward: {agree_p:.4f})")
    if bf16_bar:
        torch.testing.assert_close(logits_k, logits_p, rtol=MODEL_TOL,
                                   atol=MODEL_TOL)
        if not agree > 0.9:
            raise AssertionError(f"{cfg.name}: greedy agreement {agree} <= 0.9")
    return tokens, logits_k, logits_p


@torch.no_grad()
def check_noise(cfg, params, tokens, logits_k, logits_p):
    """The bf16 kernel forward's distance from the plain one, in relative
    norm, must not exceed the plain forward's own bf16 rounding noise (its
    distance from the plain forward in f32 compute)."""
    p32, _ = lm_forward(cfg.replace(compute_dtype="float32"), params, tokens)
    noise, rel = _rel(logits_p, p32), _rel(logits_k, logits_p)
    print(f"[forward] {cfg.name} bf16: relative distance kernel-plain "
          f"{rel:.4g}, plain bf16-f32 (its rounding noise) {noise:.4g}")
    if not rel <= noise:
        raise AssertionError(f"{cfg.name}: bf16 kernel forward {rel} from the "
                             f"plain one, above the rounding noise {noise}")


@torch.no_grad()
def check_layers(cfg, params, tokens):
    """Each layer's recurrent kernel call on the served forward's own inputs,
    against the model's plain chunked form on the same inputs (wkv6_chunked
    / ssd_chunked): elementwise at the kernel tolerance and in relative
    norm, all finite. Outside the counted main path."""
    if cfg.family == "ssm":
        name, plain = "wkv6", lambda r, k, v, w, u, chunk: r6.wkv6_chunked(
            r, k, v, w, u, r.new_zeros((r.shape[0], r.shape[2], r.shape[3],
                                        r.shape[3]), dtype=torch.float32),
            chunk)[0]
    else:
        name, plain = "ssd", lambda x, a, b, c, chunk: m2.ssd_chunked(
            x, a, b, c, x.new_zeros((x.shape[0], x.shape[2], x.shape[3],
                                     b.shape[2])), chunk)[0]
    kernel, calls = getattr(ops, name), []

    def capture(*args, chunk):
        calls.append((args, chunk))
        return kernel(*args, chunk=chunk)

    setattr(ops, name, capture)
    try:
        lm_forward(cfg.replace(use_kernels=True), params, tokens)
    finally:
        setattr(ops, name, kernel)
    worst = (0.0, 0.0)
    for args, chunk in calls:
        got, want = kernel(*args, chunk=chunk), plain(*args, chunk=chunk)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{cfg.name}: non-finite {name} output")
        rtol, atol = REC_TOL[got.dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
        rel = _rel(got.float(), want.float())
        if not rel < REL_TOL:
            raise AssertionError(f"{cfg.name}: {name} relative error {rel}")
        worst = max(worst, ((got.float() - want.float()).abs().max().item(), rel))
    print(f"[forward] {cfg.name}: {len(calls)} {name} calls of the served "
          f"forward against the model's chunked form on the same inputs: "
          f"worst max|err| {worst[0]:.3g}, relative {worst[1]:.3g}")


@torch.no_grad()
def time_forwards(cfg, params, tokens):
    """The teacher-forced forward with the kernels and the plain one, timed
    outside the counted main path."""
    _, ms_k = _timed_forward(cfg.replace(use_kernels=True), params, tokens)
    _, ms_p = _timed_forward(cfg, params, tokens)
    print(f"[forward] {cfg.name} tokens {list(tokens.shape)}: forward with "
          f"kernels {ms_k:.2f} ms, plain {ms_p:.2f} ms")


def phase_recurrent(arch, gen, device):
    """Serve a recurrent family at full width; returns (cfg, params, served
    tokens)."""
    gen_toks = serve_main(arch, gen, device)
    cfg, model, params = serve.load_model(arch, smoke=False, device=device)
    n_params = sum(p.numel() for p in params.parameters())
    cache = model.init_cache(SERVE_BATCH, PROMPT_LEN + gen)
    state_bytes = sum(t.nbytes for t in _tensors(cache))
    print(f"[serve] {cfg.name}: {n_params / 1e9:.3f} B parameters "
          f"({n_params * 2 / 1e9:.2f} GB in bf16), decode cache at batch "
          f"{SERVE_BATCH} {state_bytes / 1e9:.3f} GB")
    del cache
    decode_outside(cfg, model, params, device)
    return cfg, params, gen_toks


def _tensors(tree):
    """The tensors of a nested dict."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


@torch.no_grad()
def phase_long(cfg, params, device):
    """relic_tiny forward and loss at [4, 2048], kernel against plain."""
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


def phase_quickstart(device):
    """``repro_torch.quickstart.main`` as a user runs it, at full width on the
    card; its output must end with ``quickstart OK``."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        quickstart.main(["--device", device.type])
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        print(f"[quickstart] {line}")
    print(f"[quickstart] main(--device {device.type}) took "
          f"{time.perf_counter() - t0:.1f} s")
    if lines[-1] != "quickstart OK":
        raise AssertionError(f"quickstart ended with {lines[-1]!r}")


def _train_batch(cfg, batch, seq, seed, device):
    """Next-token batch of ``batch`` rows of ``seq`` tokens from a seeded
    numpy generator."""
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq + 1)), device=device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": torch.ones((batch, seq), device=device)}


def phase_train(device):
    """relic_tiny at full width with f32 parameters and bf16 compute, as the
    reference trains: one step with grad_accum 2 against 1 (grad_norm within
    2%, tests/test_properties.py:93-112), then TRAIN_STEPS steps on one
    batch, every loss finite and the last below the first."""
    cfg = get_config(ARCH)
    model = build_model(cfg, device)
    batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 0, device)
    gnorms = {}
    for ga in (1, 2):
        state = make_train_state(model, torch.Generator().manual_seed(0))
        step = make_train_step(model, dataclasses.replace(TRAIN_OC, grad_accum=ga))
        _, metrics = step(state, batch)
        gnorms[ga] = float(metrics["grad_norm"])
        del state
    ratio = abs(gnorms[2] - gnorms[1]) / gnorms[1]
    print(f"[train] grad_norm with grad_accum 1: {gnorms[1]:.6g}, 2: "
          f"{gnorms[2]:.6g} (relative difference {ratio:.3g}, tol 0.02)")
    if not ratio < 0.02:
        raise AssertionError(f"grad_accum 2 against 1: {ratio}")

    state = make_train_state(model, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in state["params"].parameters())
    step = make_train_step(model, TRAIN_OC)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = step(state, batch)   # the first step, outside the clock
    losses = [metrics["loss"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS - 1):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (TRAIN_STEPS - 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f} M parameters (f32), bf16 "
          f"compute, batch [{TRAIN_BATCH}, {TRAIN_SEQ}]: {ms:.2f} ms/step over "
          f"steps 2-{TRAIN_STEPS}, {tokens / ms * 1e3:.0f} tokens/s, peak "
          f"memory {peak_gb:.2f} GB")
    print(f"[train] losses {' '.join(f'{x:.4f}' for x in losses)}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    device_profile(lambda: step(state, batch),
                   f"train step [{TRAIN_BATCH}, {TRAIN_SEQ}]")


def phase_card_vs_cpu(device):
    """One train step of relic_tiny SMOKE in f32 compute on the card and on
    the CPU from the same weights and batch: loss, grad_norm and lr within
    1e-4 relative; the parameter updates within 1e-3 in relative norm (an
    AdamW update is lr * m / (sqrt(v) + eps), so a gradient entry near eps
    moves its update by a share of lr when its last bits differ)."""
    cfg = get_config(ARCH, smoke=True).replace(compute_dtype="float32")
    oc = OptConfig(warmup_steps=2, total_steps=10)
    cpu = torch.device("cpu")
    tree = train_state_to_numpy(make_train_state(
        build_model(cfg, cpu), torch.Generator().manual_seed(0)))
    out = {}
    for dev in (cpu, device):
        model = build_model(cfg, dev)
        state = train_state_from_numpy(cfg, tree, dev)
        before = {n: p.detach().clone() for n, p in state["params"].named_parameters()}
        state, metrics = make_train_step(model, oc)(
            state, _train_batch(cfg, 4, 64, 2, dev))
        delta = torch.cat([(p.detach() - before[n]).flatten().cpu()
                           for n, p in state["params"].named_parameters()])
        out[dev.type] = ({k: float(metrics[k]) for k in ("loss", "grad_norm", "lr")},
                         delta)
    (m_cpu, d_cpu), (m_card, d_card) = out["cpu"], out[device.type]
    rels = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu}
    rel_delta = ((d_card - d_cpu).norm() / d_cpu.norm()).item()
    print(f"[train] SMOKE f32 step, card against CPU: "
          + ", ".join(f"{k} {m_card[k]:.7g} / {m_cpu[k]:.7g} (relative "
                      f"{rels[k]:.3g})" for k in m_cpu)
          + f"; parameter updates relative {rel_delta:.3g} (tol 1e-3), max "
          f"{(d_card - d_cpu).abs().max().item():.3g} against lr "
          f"{m_cpu['lr']:.3g}")
    if not all(r < 1e-4 for r in rels.values()):
        raise AssertionError(f"card against CPU: {rels}")
    if not rel_delta < 1e-3:
        raise AssertionError(f"parameter updates differ by {rel_delta}")


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
    mm_entry, gated_entry = phase_matmul(device)
    entries = {
        "flash_attention": phase_kernel(device),
        "wkv6": phase_recurrence(
            "wkv6", wkv6_k, "src/repro/kernels/wkv6.py:21", _wkv6_inputs,
            lambda ins, chunk: wkv6_bound_ms(ins[0], ins[3], ins[4], chunk),
            WKV6_TEST_SHAPES, WKV6_SERVED, WKV6_LONG, torch.bfloat16, 1, device),
        "ssd": phase_recurrence(
            "ssd", ssd_k, "src/repro/kernels/ssd.py:19", _ssd_inputs,
            lambda ins, chunk: ssd_bound_ms(ins[0], ins[1], ins[2], chunk),
            SSD_TEST_SHAPES, SSD_SERVED, SSD_LONG, torch.float32, 2, device),
        "relic_matmul": mm_entry,
        "relic_matmul_gated": gated_entry,
    }
    for e in entries.values():
        e["launches"] = 0

    # The three main paths, each from launch counts of 0.
    for arch, gen, want, bf16_bar in MAIN_PATHS:
        _reset_launches()
        if arch == ARCH:
            cfg, params, gen_toks = phase_serve(device)
        else:
            cfg, params, gen_toks = phase_recurrent(arch, gen, device)
        tokens, logits_k, logits_p = phase_forward(cfg, params, gen_toks, want,
                                                   bf16_bar, device)
        _count_path(arch, want, entries)
        if not bf16_bar:
            check_noise(cfg, params, tokens, logits_k, logits_p)
        del logits_k, logits_p
        if cfg.family in ("ssm", "hybrid"):
            check_layers(cfg, params, tokens)
        time_forwards(cfg, params, tokens)
        if arch == ARCH:
            relic = (cfg, params)
        del params
        torch.cuda.empty_cache()

    # The quickstart path, from launch counts of 0.
    _reset_launches()
    phase_quickstart(device)
    _count_path("quickstart", QUICKSTART_LAUNCHES, entries)

    # Training runs the plain paths: no kernel launch.
    _reset_launches()
    phase_train(device)
    phase_card_vs_cpu(device)
    _count_path("training", {}, entries)
    torch.cuda.empty_cache()

    phase_long(*relic, device)

    print(json.dumps({"kernels": list(entries.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
