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
     launch their kernels at shapes no multiple of the TPU tiles. Flash
     attention has two designs, chosen by ``fa.wgmma_eligible``: the wgmma
     one (bf16, head_dim 64, TMA-describable layouts) is held on MHA, GQA
     and MQA at ragged lengths, Sq != Sk and the model layout, and one
     ``ops.flash_attention`` call at [4, 2048] must run exactly one device
     kernel and no copy; the CUDA-core kernel is held on f32 and small
     head dims. relic_matmul has three designs (``rm.wgmma_eligible``,
     ``rm.f32_tile``): the wgmma one (bf16 that TMA can describe) is held
     on the test shapes and ragged ones, and one call at 4096^3 must run
     one device kernel; ragged K goes to the mma.sync kernel; f32 to the
     FMA kernel with a tile by shape. The gated form takes the same
     predicate: bf16 on the wgmma ring with two accumulators (silu, gelu
     and an unknown name at relic_tiny's MLP shape, one device kernel a
     call), the rest on relic_matmul.cu's kernels. ssd has two
     (``ssd_k.tc_eligible``): the tensor-core one (f32, P = N = 64) at
     ragged T and odd H, the first one at the small test shapes, in bf16
     and at P = N = 6 (padded to 8). wkv6 has two (``wkv6_k.tc_eligible``):
     the tensor-core one (K = 64) at ragged T, in the model's layout (one
     device kernel, no copy), and the first one at K = 16, 32 and 6. The
     CUDA-core flash kernel is held at head_dim 48, 96, 256, 320 and 512
     (GQA, f32 and bf16; above 256 in slabs of 128 columns) and timed
     there. Device times come from the profiler beside the CUDA-event
     times;
  3. serve relic_tiny at full width (12 layers, d_model 768) through
     ``repro_torch.launch.serve.main`` plus three more requests through one
     ``ServeScheduler``;
  4. run the teacher-forced forward over the served tokens with
     ``use_kernels=True`` and check it against the plain forward and the
     served tokens;
  5. serve rwkv6_1p6b (24 layers, d_model 2048) and run its teacher-forced
     forward through the wkv6 kernel (its tensor-core design), the same
     way;
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
  9. the train driver, ``repro_torch.launch.train.main``, for relic_tiny at
     full width: 30 steps of Relic-prefetched batches without and with an
     async checkpoint every 10 steps, beside the same loop without the
     driver's threads; then the chaos pair of
     tests/test_checkpoint_crash.py:277-307 (a crash in the second save's
     manifest, then --resume), the state restored onto the card held bit
     for bit against the published files;
 10. the paper's nine workloads (``repro_torch.workloads``) serial and fused
     outside any substrate, paired and chunked on ``relic``, every result
     through its oracle: µs per instance and paired over serial;
 11. a long relic_tiny forward and loss at [4, 2048] with the kernel against
     the plain (chunked-attention) path.
Phases 3-4, 5, 6 and 7 are the main paths: each starts with every kernel's
launch count at 0 and its counts are read when it ends; every flash launch
there and in phase 11 must go through the wgmma design and every ssd and
wkv6 launch through the tensor-core one, and the quickstart's one
relic_matmul launch through the f32 design; phases 8, 9 and 10 must launch
no kernel (training runs the plain paths, as the reference's does, and the
workloads' kernels were never Pallas ones).

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
import shutil
import subprocess
import sys
import time
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import quickstart  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import relic_matmul as rm  # noqa: E402
from repro_torch.kernels import ssd as ssd_k  # noqa: E402
from repro_torch.kernels import wkv6 as wkv6_k  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,  # noqa: E402
                                      make_train_state, make_train_step)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import mamba2 as m2  # noqa: E402
from repro_torch.models import rwkv6 as r6  # noqa: E402
from repro_torch.models.convert import (train_state_from_numpy,  # noqa: E402
                                        train_state_to_numpy)
from repro_torch.models.lm import lm_forward, lm_loss  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.runtime.chaos import FsCrash  # noqa: E402
from repro_torch.serve import ServeScheduler  # noqa: E402
from repro_torch.tasks.api import TaskScope  # noqa: E402
from repro_torch.workloads import (available_workloads, make_workload,  # noqa: E402
                                   split_instances)

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, f32 CUDA cores and
# HBM3 rate.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32 = 495e12   # dense TF32 tensor cores
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
# The wgmma design (bf16, D=64): (h, kv) for MHA, GQA 3:1, GQA 4:1 and MQA,
# at lengths that are no multiple of its 128-row tiles, batch 2.
WGMMA_HEADS = [(4, 4), (12, 4), (8, 2), (8, 1)]
WGMMA_LENGTHS = (96, 300, 1000)
WGMMA_CROSS = (2, 128, 12, 4, 64, 320)   # (b, sq, h, kv, d, sk), non-causal
MAIN_SHAPE = (4, 2048, 12, 4, 64)  # relic_tiny's attention in the long forward
# relic_tiny's attention in the teacher-forced forward of the counted main path
TEACHER_SHAPE = (SERVE_BATCH, PROMPT_LEN + GEN, 12, 4, 64)
# zamba2_1p2b's shared attention in its teacher-forced forward (no GQA)
ZAMBA_ATTN_SHAPE = (SERVE_BATCH, PROMPT_LEN + 128, 32, 32, 64)
# Each kernel's launch counter: name -> (module, attribute).
COUNTERS = {"flash_attention": (fa, "launches"), "wkv6": (wkv6_k, "launches"),
            "ssd": (ssd_k, "launches"), "relic_matmul": (rm, "launches"),
            "relic_matmul_gated": (rm, "gated_launches")}
# The redesigned designs' counters: name -> (module, attribute), beside the
# kernel's own count in COUNTERS.
REDESIGNS = {"flash_attention": (fa, "wgmma_launches"),
             "relic_matmul": (rm, "wgmma_launches"),
             "relic_matmul_gated": (rm, "gated_wgmma_launches"),
             "ssd": (ssd_k, "tc_launches"),
             "wkv6": (wkv6_k, "tc_launches")}
# Head sizes the CUDA-core flash kernel takes beyond the models' 64: the
# next instance up (48), instances of their own (96: phi3_mini; 256:
# paligemma) and the slabs of 128 columns above 256 (320, 512); (b, s, h,
# kv) GQA 4:1 at a ragged length, and the timed shape.
FMA_HEAD_DIMS = (48, 96, 256, 320, 512)
FMA_HEAD_SHAPE = (2, 200, 8, 2)
FMA_HEAD_TIMED = (2, 1024, 8, 2)
SOURCES = ["flash_attention", "flash_attention_wgmma", "relic_matmul",
           "relic_matmul_wgmma", "ssd", "wkv6"]   # csrc/<name>.cu
# The recurrent kernels: f32 1e-3, bf16 rtol 2e-2 / atol 2e-1
# (tests/test_kernels.py:88-93,108-111).
REC_TOL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (2e-2, 2e-1)}
# wkv6 shapes (b, h, t, k, chunk): tests/test_kernels.py:75-79, a ragged
# length, the served rwkv6_1p6b forward [8, 192] and a long one.
WKV6_TEST_SHAPES = [(2, 2, 64, 16, 16), (1, 4, 128, 32, 32), (2, 2, 96, 16, 32),
                    (2, 4, 96, 64, 64),
                    # K = 64 (the tensor-core design) at T no multiple of
                    # its chunk of 32 or of a sub-chunk, and K = 6 (the
                    # first design, padded to 8)
                    (1, 3, 45, 64, 64), (2, 2, 300, 64, 64), (2, 3, 7, 64, 64),
                    (1, 2, 37, 6, 16)]
WKV6_LAYOUT = (2, 3, 70, 64)   # (b, h, t, k) in the model's layout
WKV6_SERVED = (SERVE_BATCH, 32, PROMPT_LEN + 64, 64, 64)
WKV6_LONG = (4, 32, 2048, 64, 64)
# ssd shapes (b, h, t, p, n, chunk): tests/test_kernels.py:97-100, a ragged
# length, the served zamba2_1p2b forward [8, 256] and a long one.
SSD_TEST_SHAPES = [(2, 2, 64, 16, 8, 16), (1, 4, 128, 32, 16, 32),
                   (2, 4, 200, 64, 64, 128),
                   # P = N = 64 (the tensor-core design) with H no multiple
                   # of its head group of 2 and T no multiple of a chunk
                   (1, 3, 45, 64, 64, 32), (2, 5, 77, 64, 64, 128),
                   # P = N = 6: the first design on copies padded to 8
                   (1, 2, 45, 6, 6, 32)]
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
# Ragged bf16 shapes the wgmma design takes (M, N or K no multiple of its
# 128 x 128/256 x 64 tiles, K and N multiples of 8), and relic_tiny's down
# product.
MM_WGMMA_RAGGED = [(300, 264, 200), (2048, 768, 2048), (130, 136, 72)]
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
# The train driver at the same batch: steps and checkpoint interval of the
# timed runs.
DRIVER_STEPS, DRIVER_CKPT_EVERY = 30, 10
WORKLOAD_PASSES, WORKLOAD_REPS = 3, 5   # passes over the workloads; runs a pass


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


def wkv6_tc_bound_ms(r, logw, u, chunk: int, sub: int = 16):
    """Least time for wkv6 on these inputs in the tensor-core design's form:
    per chunk of c steps, the pairwise decay only inside sub-chunks of
    ``sub`` steps (4 operations and one exponential each pair and channel)
    and the other strictly causal pairs as a product of factored operands
    (one more exponential, scale and subtraction per operand element); the
    products (the factored scores, scores @ v, r_dec @ state and the state
    update) on the tensor cores in 3xTF32 (three TF32 products each, 495
    TFLOP/s / 3), the rest of the work, exponentials included, at the f32
    rate, as ``ssd_tc_bound_ms`` does; bytes as ``wkv6_bound_ms``. Returns
    (ms, bound_by)."""
    b, h, t, kk = r.shape
    prods = rest = exps = 0
    for c in _chunks(t, chunk):
        diag = sum(n * (n - 1) // 2 for n in _chunks(c, sub))
        off = c * (c - 1) // 2 - diag
        prods += 2 * off * kk + c * (c + 1) * kk + 4 * c * kk * kk
        rest += 4 * diag * kk + 3 * c * kk + 4 * c * kk + 2 * kk * kk + 3 * c * kk
        exps += diag * kk + 2 * c * kk + kk + c * kk
    prods, rest, exps = prods * b * h, rest * b * h, exps * b * h
    nbytes = 4 * r.nbytes + logw.nbytes + u.nbytes
    t_ops = prods / (PEAK_TF32 / 3) + (rest + exps) / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _ssd_work(x, a, bmat, chunk: int):
    """The chunked ssd's arithmetic on these inputs, per chunk of c steps:
    C B^T once per batch row (the heads share it), and per head W @ x,
    C @ state^T and the state update (the four products), the decay of the
    c(c+1)/2 kept pairs (one exponential each) and the rescalings.
    Returns (product flops, other flops, exponentials, bytes): x, a, b, c
    read once and y written once."""
    bb, h, t, p = x.shape
    n = bmat.shape[-1]
    prods = rest = exps = 0
    for c in _chunks(t, chunk):
        pairs = c * (c + 1) // 2
        prods += bb * 2 * pairs * n + bb * h * (2 * pairs * p + 4 * c * n * p)
        rest += bb * h * (2 * pairs + 3 * c * p + 2 * c + 2 * p * n)
        exps += bb * h * (pairs + 2 * c + 1)
    nbytes = 2 * x.nbytes + a.nbytes + 2 * bmat.nbytes
    return prods, rest, exps, nbytes


def ssd_bound_ms(x, a, bmat, chunk: int):
    """Least time for ssd on these inputs with all of its arithmetic at the
    f32 CUDA-core rate (``_ssd_work``). Returns (ms, bound_by, flops, exps,
    bytes)."""
    prods, rest, exps, nbytes = _ssd_work(x, a, bmat, chunk)
    ms, bound_by = _bound(prods + rest, exps, nbytes)
    return ms, bound_by, prods + rest, exps, nbytes


def ssd_tc_bound_ms(x, a, bmat, chunk: int):
    """Least time for ssd on these inputs with the four products on the
    tensor cores in 3xTF32 (three TF32 products each, 495 TFLOP/s / 3) and
    the rest of its arithmetic at the f32 rate. Returns (ms, bound_by)."""
    prods, rest, exps, nbytes = _ssd_work(x, a, bmat, chunk)
    t_ops = prods / (PEAK_TF32 / 3) + (rest + exps) / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def device_events(fn, attempts: int = 3):
    """Run ``fn`` under torch.profiler; returns its wall time in ms and the
    card's kernel, copy and memset events of the trace. The profiler now
    and then records no device event at all (seen on the H100), so an
    empty trace is taken again, up to ``attempts`` runs of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    trace = os.path.join(ROOT, "build", "chip_smoke_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = [e for e in json.load(f)["traceEvents"] if "dur" in e
                      and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if events:
            break
    return wall_ms, events


def kernel_ms(fn, n: int = 20, attempts: int = 3):
    """Mean device time of the kernels one call of ``fn`` runs, from the
    profiler's trace of ``n`` calls: what the card spends, without the gaps
    that the host's issue rate leaves between back-to-back calls. A trace
    whose kernel count is no multiple of ``n`` is incomplete and is taken
    again; None when no run gives a whole trace (not measured)."""
    fn()
    for _ in range(attempts):
        _, events = device_events(lambda: [fn() for _ in range(n)])
        kernels = [e["dur"] for e in events if e.get("cat") == "kernel"]
        if kernels and len(kernels) % n == 0:
            return sum(kernels) / n / 1e3
    return None


def device_profile(fn, label: str):
    """Run ``fn`` once under torch.profiler and print its wall time, the
    card's busy time (the union of its kernel and copy intervals) and the
    costliest kernels. The profiler's own cost inflates the wall time."""
    wall_ms, events = device_events(fn)
    if not events:
        print(f"[profile] {label}: wall {wall_ms:.2f} ms; device time not "
              f"measured (the profiler recorded no kernels)")
        return
    busy, end = 0.0, float("-inf")
    for ts, te in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        busy += max(0.0, te - max(ts, end))
        end = max(end, te)
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile] {label}: wall {wall_ms:.2f} ms under the profiler, card "
          f"busy {busy / 1e3:.2f} ms ({busy / 1e3 / wall_ms:.1%}, idle "
          f"{1 - busy / 1e3 / wall_ms:.1%}), {len(events)} device ops")
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
                if ("registers" in line or "spill" in line
                        or "Compiling entry function" in line):
                    print(f"[build] {line.strip()[:160]}")


def _qkv(gen, b, s, h, kv, d, dtype, device, sk=None):
    """Seeded q [b, h, s, d] and k, v [b, kv, sk (default s), d]."""
    def mk(heads, length):
        x = torch.randn((b, heads, length, d), generator=gen, dtype=torch.float32)
        return x.to(device=device, dtype=dtype)
    return mk(h, s), mk(kv, sk or s), mk(kv, sk or s)


def check_kernel(fn, gen, shape, dtype, causal, device, sk=None):
    """One flash design (``fn``: ``flash_attention_wgmma`` or
    ``flash_attention_fma``) against the plain version on one seeded input
    of ``shape`` (b, s, h, kv, d), kv length ``sk`` (default s): finite,
    elementwise at the test tolerance and in relative norm. Returns the
    inputs and the largest absolute difference."""
    b, s, h, kv, d = shape
    q, k, v = _qkv(gen, b, s, h, kv, d, dtype, device, sk)
    got = fn(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    err = _hold(f"{fn.__name__} b{b} s{s}{f' sk{sk}' if sk else ''} h{h} "
                f"kv{kv} d{d} causal={causal}", got, want, TOL[dtype],
                TOL[dtype])
    return (q, k, v), err


def _launched(counter: str, n: int, fn, label: str):
    """Run ``fn``; ``fa.<counter>`` must rise by exactly ``n``."""
    before = getattr(fa, counter)
    out = fn()
    if getattr(fa, counter) - before != n:
        raise AssertionError(f"{label}: {getattr(fa, counter) - before} "
                             f"{counter}, want {n}")
    return out


def time_flash(label, q, k, v, iters):
    """The wgmma design at one causal bf16 shape beside the CUDA-core
    kernel, the plain version, SDPA (the library yardstick, kv heads
    repeated outside the timed call; the port never calls it) and the
    bound: CUDA-event times of back-to-back calls (at small shapes the
    host's issue rate) and the profiler's device times. Returns the numbers
    as one dict."""
    h, kv = q.shape[1], k.shape[1]
    k_rep = torch.repeat_interleave(k, h // kv, dim=1)
    v_rep = torch.repeat_interleave(v, h // kv, dim=1)
    ms = time_ms(lambda: fa.flash_attention_wgmma(q, k, v, causal=True), iters)
    fma_ms = time_ms(lambda: fa.flash_attention_fma(q, k, v, causal=True),
                     max(iters // 4, 3))
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True),
                       max(iters // 4, 3))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k_rep, v_rep, is_causal=True), iters)
    device_ms = kernel_ms(lambda: fa.flash_attention_wgmma(q, k, v, causal=True))
    library_device_ms = kernel_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k_rep, v_rep, is_causal=True))
    bound_ms, bound_by, flops, nbytes = attention_bound_ms(q, k, v, True)
    shape = f"q{list(q.shape)} kv{list(k.shape)} bf16 causal"
    tflops = flops / (device_ms or ms) / 1e9

    def fmt(x):
        return "not measured" if x is None else f"{x:.4f} ms"
    print(f"[kernel] {label} {shape}: wgmma {ms:.4f} ms (device "
          f"{fmt(device_ms)}, {tflops:.1f} TFLOP/s), CUDA-core kernel "
          f"{fma_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms "
          f"(device {fmt(library_device_ms)}); bound "
          f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB)")
    return dict(shape=shape, ms=ms, device_ms=device_ms, fma_ms=fma_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=library_device_ms, bound_ms=bound_ms,
                bound_by=bound_by, tflops=tflops)


def time_fma(q, k, v):
    """The CUDA-core kernel at one causal shape beside the plain version,
    SDPA (the library yardstick, kv heads repeated outside the timed call)
    and the bound; returns the numbers as one dict."""
    h, kv = q.shape[1], k.shape[1]
    k_rep = torch.repeat_interleave(k, h // kv, dim=1)
    v_rep = torch.repeat_interleave(v, h // kv, dim=1)
    ms = time_ms(lambda: fa.flash_attention_fma(q, k, v, causal=True), 10)
    device_ms = kernel_ms(lambda: fa.flash_attention_fma(q, k, v, causal=True), 10)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True), 5)
    library_ms = kernel_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k_rep, v_rep, is_causal=True), 10)
    bound_ms, bound_by, flops, nbytes = attention_bound_ms(q, k, v, True)
    shape = f"q{list(q.shape)} kv{list(k.shape)} {str(q.dtype)[6:]} causal"
    dev = "not measured" if device_ms is None else f"{device_ms:.4f} ms"
    lib = "not measured" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"[kernel] CUDA-core flash {shape}: {ms:.4f} ms (device {dev}), "
          f"plain {plain_ms:.4f} ms, sdpa device {lib}; bound {bound_ms:.4f} "
          f"ms by {bound_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return dict(shape=shape, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_kernel(device):
    gen = torch.Generator().manual_seed(0)
    dtype = torch.bfloat16
    # The CUDA-core kernel keeps f32, head_dims 16/32/128 and layouts TMA
    # cannot describe: held on the test shapes in both dtypes.
    for shape in KERNEL_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                check_kernel(fa.flash_attention_fma, gen, shape, dt, causal, device)

    # The wgmma design: MHA, GQA 3:1 and 4:1, MQA at ragged lengths, Sq != Sk.
    for h, kv in WGMMA_HEADS:
        for s in WGMMA_LENGTHS:
            for causal in (True, False):
                check_kernel(fa.flash_attention_wgmma, gen, (2, s, h, kv, 64),
                             dtype, causal, device)
    b, sq, h, kv, d, sk = WGMMA_CROSS
    check_kernel(fa.flash_attention_wgmma, gen, (b, sq, h, kv, d), dtype, False,
                 device, sk=sk)

    # The dispatch: bf16 D=64 goes to the wgmma design, f32 and D=32 do not.
    for dt, d, n in ((torch.bfloat16, 64, 1), (torch.float32, 64, 0),
                     (torch.bfloat16, 32, 0)):
        q, k, v = _qkv(gen, 1, 96, 4, 2, d, dt, device)
        got = _launched("wgmma_launches", n, lambda: _launched(
            "launches", 1, lambda: fa.flash_attention_cuda(q, k, v),
            "flash_attention_cuda"), f"flash_attention_cuda {dt} d{d}")
        _hold(f"flash_attention_cuda d{d}", got,
              fa.flash_attention_plain(q, k, v), TOL[dt], TOL[dt])

    # Head sizes beyond the models' 64 run the CUDA-core kernel: 48 on the
    # next instance up (columns zero-filled on chip), 96 and 256 on their
    # own, 320 and 512 in slabs of 128 columns.
    head_dims = []
    for d in FMA_HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v = _qkv(gen, *FMA_HEAD_SHAPE, d, dt, device)
                got = _launched("wgmma_launches", 0, lambda: _launched(
                    "launches", 1, lambda: fa.flash_attention_cuda(
                        q, k, v, causal=causal), "flash_attention_cuda"),
                    f"flash_attention_cuda d{d}")
                _hold(f"flash_attention_cuda q{list(q.shape)} kv{list(k.shape)} "
                      f"causal={causal} (CUDA-core kernel)", got,
                      fa.flash_attention_plain(q, k, v, causal=causal),
                      TOL[dt], TOL[dt])
        q, k, v = _qkv(gen, *FMA_HEAD_TIMED, d, dtype, device)
        head_dims.append(time_fma(q, k, v))

    # ops.flash_attention hands the model layout [B, S, H, D] to the wgmma
    # design as it is, at lengths no multiple of its tiles.
    for s in (96, 300):
        q, k, v = (x.transpose(1, 2).contiguous()
                   for x in _qkv(gen, 1, s, 4, 2, 64, dtype, device))
        got = _launched("wgmma_launches", 1, lambda: ops.flash_attention(
            q, k, v, causal=True), f"ops.flash_attention at S={s}")
        want = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2)).transpose(1, 2)
        _hold(f"ops.flash_attention model layout S={s}", got, want,
              TOL[dtype], TOL[dtype])

    (q, k, v), err = check_kernel(fa.flash_attention_wgmma, gen, TEACHER_SHAPE,
                                  dtype, True, device)
    teacher = {**time_flash("teacher-forced shape", q, k, v, 50),
               "max_abs_err": err}
    (q, k, v), err = check_kernel(fa.flash_attention_wgmma, gen,
                                  ZAMBA_ATTN_SHAPE, dtype, True, device)
    zamba = {**time_flash("zamba2 shared-attention shape", q, k, v, 50),
             "max_abs_err": err}
    (q, k, v), max_err = check_kernel(fa.flash_attention_wgmma, gen, MAIN_SHAPE,
                                      dtype, True, device)
    main = time_flash("main shape", q, k, v, 20)

    # One ops.flash_attention call in the model layout at [4, 2048]: exactly
    # one device operation, the wgmma kernel (no layout copy, no cast).
    qm, km, vm = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    _one_kernel(lambda: ops.flash_attention(qm, km, vm, causal=True),
                f"ops.flash_attention at q{list(qm.shape)} (model layout)",
                "fa_wgmma_kernel")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
            "replaces": "src/repro/kernels/flash_attention.py:27",
            "design": ("persistent, one CTA per SM over 128-row q tiles "
                       "heaviest first; wgmma for both products (P from "
                       "registers); K/V by TMA into a 2-stage mbarrier ring "
                       "fed by one producer thread; 4-D tensor maps over the "
                       "caller's strides; bf16 D=64. f32, every other D "
                       "(instances 16/32/64/96/128/256, the next one up for "
                       "any other up to 256, slabs of 128 columns above) and "
                       "non-TMA layouts: "
                       "src/repro_torch/kernels/csrc/flash_attention.cu"),
            "launches": None, "max_abs_err": max_err, **main,
            "other_shapes": [teacher, zamba], "head_dims": head_dims}


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
                     served, long_, main_dtype, seed, device, redesign=None,
                     tc_bound=None):
    """Hold a recurrent kernel (``mod``: wkv6 or ssd) against its plain
    version at the test shapes in f32 and bf16, then at the served path's
    shape and a long one in ``main_dtype``, timing kernel and plain version
    there (CUDA events, and the profiler's device time for the kernel).
    Shapes end with the chunk length. ``redesign``: (counter, predicate) of
    a kernel with two designs; every call must go through the redesigned
    one exactly when the predicate holds on its inputs. ``tc_bound``: a
    second bound, with the products at the tensor cores' rate. Returns the
    kernel's entry of the numbers line (its numbers at the served shape)."""
    cuda_fn, plain_fn = getattr(mod, f"{name}_cuda"), getattr(mod, f"{name}_plain")
    gen = torch.Generator().manual_seed(seed)

    def call(ins, chunk, label):
        before = getattr(mod, redesign[0]) if redesign else 0
        out = cuda_fn(*ins, chunk=chunk)
        if redesign:
            want = int(redesign[1](*ins))
            if getattr(mod, redesign[0]) - before != want:
                raise AssertionError(f"{label}: {redesign[0]} rose by "
                                     f"{getattr(mod, redesign[0]) - before}, "
                                     f"want {want}")
        return out

    for *shape, chunk in test_shapes:
        for dtype in (torch.float32, torch.bfloat16):
            ins = make_inputs(gen, *shape, dtype, device)
            label = f"{name} {shape} chunk {chunk}"
            _hold(label, call(ins, chunk, label), plain_fn(*ins), *REC_TOL[dtype])
    timed = {}
    for label, (*shape, chunk), iters in (("served", served, 20),
                                          ("long", long_, 3)):
        ins = make_inputs(gen, *shape, main_dtype, device)
        err = _hold(f"{name} {shape} chunk {chunk} ({label})",
                    call(ins, chunk, label), plain_fn(*ins),
                    *REC_TOL[main_dtype])
        ms = time_ms(lambda: cuda_fn(*ins, chunk=chunk), iters)
        device_ms = kernel_ms(lambda: cuda_fn(*ins, chunk=chunk), iters)
        plain_ms = time_ms(lambda: plain_fn(*ins), iters, warmup=1)
        bound_ms, bound_by, flops, exps, nbytes = bound(ins, chunk)
        desc = f"{shape} {str(main_dtype)[6:]} chunk {chunk}"
        dev = "not measured" if device_ms is None else f"{device_ms:.4f} ms"
        print(f"[kernel] {name} {label} shape {desc}: kernel {ms:.4f} ms "
              f"(device {dev}), plain {plain_ms:.4f} ms; bound {bound_ms:.4f} "
              f"ms by {bound_by}")
        print(f"[kernel]   {name} {label}: {flops / 1e9:.3f} GFLOP of f32 "
              f"arithmetic, {nbytes / 1e6:.2f} MB; "
              f"{flops / (device_ms or ms) / 1e9:.1f} TFLOP/s achieved")
        print(f"[kernel]   {name} {label}: {exps / 1e9:.4f} G exponentials")
        timed[label] = dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, shape=desc)
        if tc_bound:
            tc_ms, tc_by = tc_bound(ins, chunk)
            print(f"[kernel]   {name} {label}: bound with the products on the "
                  f"tensor cores in 3xTF32 {tc_ms:.4f} ms by {tc_by}")
            timed[label].update(tc_bound_ms=tc_ms, tc_bound_by=tc_by)
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": None, **timed["served"],
            "library_ms": None, "long": timed["long"]}


def phase_wkv6_layout(device):
    """``ops.wkv6`` on the model's [B, T, H, K] layout, as rwkv6 calls it:
    the tensor-core design reads and writes that layout as it lies, so one
    call is exactly one device kernel (no copy, no cast), held against the
    plain version."""
    gen = torch.Generator().manual_seed(4)
    b, h, t, kk = WKV6_LAYOUT
    r, k, v, logw, u = _wkv6_inputs(gen, b, h, t, kk, torch.bfloat16, device)
    model = [x.transpose(1, 2).contiguous() for x in (r, k, v, logw)]
    before = wkv6_k.tc_launches
    got = ops.wkv6(*model, u, chunk=64)
    if wkv6_k.tc_launches - before != 1:
        raise AssertionError("ops.wkv6 in the model layout did not take the "
                             "tensor-core design")
    _hold(f"ops.wkv6 model layout [{b}, {t}, {h}, {kk}]", got,
          wkv6_k.wkv6_plain(r, k, v, logw, u).transpose(1, 2),
          *REC_TOL[torch.bfloat16])
    _one_kernel(lambda: ops.wkv6(*model, u, chunk=64),
                f"ops.wkv6 at [{b}, {t}, {h}, {kk}] (model layout)", "wkv6_tc_kernel")


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


def _mm_call(x, w, out_dtype=None):
    """relic_matmul_cuda; returns (out, the design that ran)."""
    before = rm.wgmma_launches
    out = rm.relic_matmul_cuda(x, w, out_dtype=out_dtype)
    (m, _), n, n_sm = x.shape, w.shape[1], rm.sm_count(x.device)
    if rm.wgmma_launches - before:
        design = f"wgmma, 128 x {rm.wgmma_tile_n(m, n, n_sm)} tiles"
    elif x.dtype == torch.float32:
        bm, bn = rm.F32_TILES[rm.f32_tile(m, n, n_sm)]
        design = f"f32 FMA, {bm} x {bn} tiles"
    else:
        design = "mma.sync"
    return out, design


def _one_kernel(fn, label, name):
    """One call of ``fn`` must run exactly one device operation, the kernel
    ``name``: no copy, no memset, no second kernel."""
    fn()   # built and warm
    _, events = device_events(fn)
    names = [e["name"] for e in events]
    print(f"[kernel] one {label} call ran {len(names)} device operation(s): "
          f"{names}")
    if len(names) != 1 or name not in names[0]:
        raise AssertionError(f"{label} ran {names}, want the one {name}")


def phase_matmul(device):
    """relic_matmul and relic_matmul_gated against their plain versions on
    the card: the test shapes in f32 and bf16 (the ragged one takes the
    mma.sync kernel, the others in bf16 the wgmma design), ragged bf16 shapes
    the wgmma design takes, an f32 output of bf16 inputs and the reverse,
    the gated form with silu, gelu and an unknown name (no activation) on
    both of its routes, then timing at the quickstart's shape, relic_tiny's MLP shapes and a square
    one beside the bound, the plain version and torch.matmul (CUDA events
    and the profiler's device times). One call at 4096^3 bf16 must run one
    device kernel, the wgmma design's. Returns the two kernels' entries of
    the numbers line (relic_matmul's at the quickstart's shape, the gated
    form's at relic_tiny's MLP shape)."""
    gen = torch.Generator(device=device).manual_seed(3)
    shapes = [(m, n, k, dt) for m, n, k in MM_TEST_SHAPES
              for dt in (torch.float32, torch.bfloat16)]
    shapes += [(m, n, k, torch.bfloat16) for m, n, k in MM_WGMMA_RAGGED]
    for m, n, k, dtype in shapes:
        x, (w,) = _mm_inputs(gen, m, n, k, dtype, 1, device)
        want_wgmma = dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0
        for od in (None, torch.float32 if dtype == torch.bfloat16 else torch.bfloat16):
            got, design = _mm_call(x, w, od)
            if design.startswith("wgmma") != want_wgmma:
                raise AssertionError(f"relic_matmul [{m}, {k}] @ [{k}, {n}] "
                                     f"{dtype} ran {design}")
            tol = MM_TOL[od or dtype]
            _hold(f"{_mm_label('relic_matmul', m, n, k)} ({design}, out "
                  f"{str(od or dtype)[6:]})", got,
                  rm.relic_matmul_plain(x, w, od), *tol)
    # The gated form: the wgmma ring where the predicate holds for x with
    # each weight (bf16, K and N multiples of 8), relic_matmul.cu elsewhere.
    gated_shapes = [(*GATED_TEST, dt) for dt in (torch.float32, torch.bfloat16)]
    gated_shapes += [(m, n, k, torch.bfloat16) for m, n, k in MM_WGMMA_RAGGED]
    gated_shapes += [(100, 60, 36, torch.bfloat16), (*GATED_MLP, torch.bfloat16)]
    for m, n, k, dtype in gated_shapes:
        x, (wg, wu) = _mm_inputs(gen, m, n, k, dtype, 2, device)
        want_wgmma = dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0
        for act in ("silu", "gelu", "none"):
            before = rm.gated_wgmma_launches
            got = rm.relic_matmul_gated_cuda(x, wg, wu, act=act)
            if (rm.gated_wgmma_launches - before == 1) != want_wgmma:
                raise AssertionError(f"relic_matmul_gated [{m}, {k}] @ [{k}, {n}] "
                                     f"{dtype}: wgmma launches "
                                     f"{rm.gated_wgmma_launches - before}")
            _hold(f"{_mm_label('relic_matmul_gated', m, n, k, act)} "
                  f"({'wgmma' if want_wgmma else 'relic_matmul.cu'})", got,
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

    def fmt(v):
        return "not measured" if v is None else f"{v:.4f} ms"

    timed = []
    for label, m, n, k, dtype, iters in MM_TIMED:
        x, (w,) = _mm_inputs(gen, m, n, k, dtype, 1, device)
        desc = f"{_mm_label(label, m, n, k)} {str(dtype)[6:]}"
        got, design = _mm_call(x, w)
        err = _hold(f"{_mm_label(label, m, n, k)} ({design})", got,
                    rm.relic_matmul_plain(x, w), *MM_TOL[dtype])
        ms = time_ms(lambda: rm.relic_matmul_cuda(x, w), iters)
        device_ms = kernel_ms(lambda: rm.relic_matmul_cuda(x, w), iters)
        plain_ms = time_ms(lambda: rm.relic_matmul_plain(x, w), iters)
        # The library yardstick: torch.matmul in the input type (cuBLAS; TF32
        # is off, so f32 stays f32). The port never calls it.
        library_ms = time_ms(lambda: torch.matmul(x, w), iters)
        library_device_ms = kernel_ms(lambda: torch.matmul(x, w), iters)
        bound_ms, bound_by, flops, nbytes = matmul_bound_ms(m, n, k, dtype)
        print(f"[kernel] {desc}: kernel ({design}) {ms:.4f} ms (device "
              f"{fmt(device_ms)}), plain {plain_ms:.4f} ms, torch.matmul "
              f"{library_ms:.4f} ms (device {fmt(library_device_ms)}); bound "
              f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB); {flops / (device_ms or ms) / 1e9:.1f} "
              f"TFLOP/s achieved")
        timed.append(dict(shape=desc, design=design, max_abs_err=err, ms=ms,
                          device_ms=device_ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms,
                          library_device_ms=library_device_ms))

    x, (w,) = _mm_inputs(gen, 4096, 4096, 4096, torch.bfloat16, 1, device)
    _one_kernel(lambda: rm.relic_matmul_cuda(x, w), "relic_matmul_cuda at "
                "4096^3 bf16", "mm_wgmma_kernel")

    m, n, k = GATED_MLP
    dtype = torch.bfloat16
    x, (wg, wu) = _mm_inputs(gen, m, n, k, dtype, 2, device)
    bn = rm.wgmma_tile_n(m, n, rm.sm_count(device), rm.GATED_WGMMA_TILES_N)
    desc = (f"{_mm_label('relic_matmul_gated', m, n, k, 'silu')} "
            f"{str(dtype)[6:]} (wgmma, 128 x {bn} tiles per weight)")
    err = _hold(_mm_label("relic_matmul_gated", m, n, k, "silu"),
                rm.relic_matmul_gated_cuda(x, wg, wu, act="silu"),
                rm.relic_matmul_gated_plain(x, wg, wu, "silu"), *GATED_TOL[dtype])
    ms = time_ms(lambda: rm.relic_matmul_gated_cuda(x, wg, wu, act="silu"), 50)
    device_ms = kernel_ms(lambda: rm.relic_matmul_gated_cuda(x, wg, wu, act="silu"))
    plain_ms = time_ms(lambda: rm.relic_matmul_gated_plain(x, wg, wu, "silu"), 50)
    # For information only: no single PyTorch call computes the gated form;
    # three do (two torch.matmul, then silu(g) * u). Their summed device time.
    calls_ms = kernel_ms(lambda: torch.nn.functional.silu(x @ wg) * (x @ wu))
    bound_ms, bound_by, flops, nbytes = matmul_bound_ms(m, n, k, dtype, 2)
    print(f"[kernel] {desc}: kernel {ms:.4f} ms (device {fmt(device_ms)}), "
          f"plain {plain_ms:.4f} ms, three library calls (x @ Wg, x @ Wu, "
          f"silu(g) * u) device {fmt(calls_ms)}; bound {bound_ms:.4f} ms by "
          f"{bound_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); "
          f"{flops / (device_ms or ms) / 1e9:.1f} TFLOP/s achieved")
    _one_kernel(lambda: rm.relic_matmul_gated_cuda(x, wg, wu, act="silu"),
                "relic_matmul_gated_cuda at relic_tiny's MLP shape", "mm_wgmma_kernel")
    # What the epilogue's activation costs: the same call with each one.
    acts_ms = {act: kernel_ms(lambda: rm.relic_matmul_gated_cuda(x, wg, wu, act=act))
               for act in ("none", "silu", "gelu")}
    print(f"[kernel] {desc}: device time by activation "
          + ", ".join(f"{a} {fmt(v)}" for a, v in acts_ms.items()))
    return (
        {"name": "relic_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/relic_matmul.cu",
         "replaces": "src/repro/kernels/relic_matmul.py:28", "launches": None,
         **timed[0],
         "design": ("f32: IEEE FMA, tile by shape (128 x 128 to 16 x 32), "
                    "3-stage cp.async ring over K; bf16 that TMA can describe: "
                    "src/repro_torch/kernels/csrc/relic_matmul_wgmma.cu "
                    "(persistent, one TMA producer thread, 4-stage mbarrier "
                    "ring, two wgmma consumer warpgroups, w MN-major through "
                    "the transpose bit, 128 x 128/256 tiles by shape); other "
                    "bf16: mma.sync"),
         "other_shapes": timed[1:]},
        {"name": "relic_matmul_gated", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/relic_matmul_wgmma.cu",
         "replaces": "src/repro/kernels/relic_matmul.py:73", "launches": None,
         "max_abs_err": err, "ms": ms, "device_ms": device_ms,
         "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": None, "library_calls_device_ms": calls_ms, "shape": desc,
         "device_ms_by_act": acts_ms,
         "design": ("bf16 that TMA can describe: the wgmma ring of "
                    "relic_matmul_wgmma.cu with a tile of each weight per "
                    "stage (one expect_tx), two f32 accumulators per "
                    "consumer warpgroup, act(gate) * up in the staged "
                    "epilogue; 128 x 128 or 128 x 64 per weight by shape. "
                    "f32 and other bf16: "
                    "src/repro_torch/kernels/csrc/relic_matmul.cu")})


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
    for mod, attr in (*COUNTERS.values(), *REDESIGNS.values()):
        setattr(mod, attr, 0)


def _count_path(label, want, entries):
    """The launches since the last reset must be exactly ``want`` ({kernel:
    count}); every flash attention, ssd and wkv6 launch must take its
    redesigned design (wgmma; tensor cores), and no relic_matmul launch the
    wgmma one (the only product on a main path, the quickstart's, is f32). The counts
    are added to the kernels' entries of the numbers line."""
    got = {n: c for n, c in _launches().items() if c}
    redesigned = {n: getattr(mod, attr) for n, (mod, attr) in REDESIGNS.items()}
    print(f"[main] {label}: kernel launches {got}; through the redesigned "
          f"designs {redesigned}")
    if got != want:
        raise AssertionError(f"{label} launched {got}, want {want}")
    expect = {"flash_attention": got.get("flash_attention", 0),
              "ssd": got.get("ssd", 0), "wkv6": got.get("wkv6", 0),
              "relic_matmul": 0, "relic_matmul_gated": 0}
    if redesigned != expect:
        raise AssertionError(f"{label}: launches through the redesigned "
                             f"designs {redesigned}, want {expect}")
    for name, count in got.items():
        entries[name]["launches"] += count
    for name, count in redesigned.items():
        entries[name]["redesign_launches"] = (
            entries[name].get("redesign_launches", 0) + count)


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
    outside the counted main path, and the kernel forward's device time
    under the profiler."""
    cfg_k = cfg.replace(use_kernels=True)
    _, ms_k = _timed_forward(cfg_k, params, tokens)
    _, ms_p = _timed_forward(cfg, params, tokens)
    print(f"[forward] {cfg.name} tokens {list(tokens.shape)}: forward with "
          f"kernels {ms_k:.2f} ms, plain {ms_p:.2f} ms")
    device_profile(lambda: lm_forward(cfg_k, params, tokens),
                   f"{cfg.name} forward {list(tokens.shape)} with the kernels")


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
    before, before_wgmma = fa.launches, fa.wgmma_launches
    loss, _ = lm_loss(cfg_k, params, batch)
    if not torch.isfinite(loss):
        raise AssertionError(f"loss {loss.item()}")
    launched = (fa.launches - before, fa.wgmma_launches - before_wgmma)
    print(f"[long] flash launches in the loss {launched[0]}, of which through "
          f"the wgmma design {launched[1]}")
    if launched != (cfg.n_layers, cfg.n_layers):
        raise AssertionError(f"{launched} launches in the loss, want "
                             f"{cfg.n_layers} through the wgmma design")

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
    return ms


class _StampedLines(io.TextIOBase):
    """A stdout that keeps each line with the host clock at its end."""

    def __init__(self):
        self.lines: list[tuple[float, str]] = []
        self._part = ""

    def write(self, text):
        self._part += text
        while "\n" in self._part:
            line, self._part = self._part.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(text)


def _driver(argv, label):
    """``train.main(argv)`` with its log captured and echoed: (last loss,
    [(step, loss, host clock)] of its step lines, the whole log)."""
    out = _StampedLines()
    with contextlib.redirect_stdout(out):
        loss = train.main(argv)
    steps = []
    for t, line in out.lines:
        print(f"[driver] {label}: {line}")
        if line.startswith("step "):
            f = line.split()
            steps.append((int(f[1]), float(f[3]), t))
    return loss, steps, "\n".join(line for _, line in out.lines)


def _driver_ms(steps):
    """Host ms a step over the logged steps after the first (every step is
    logged, and each log line waits for its step's loss)."""
    (s0, _, t0), (s1, _, t1) = steps[0], steps[-1]
    return (t1 - t0) * 1e3 / (s1 - s0)


def _hold_losses(label, steps, n):
    losses = [x for _, x, _ in steps]
    if len(losses) != n or not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: {len(losses)} losses, want {n} finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall: {losses}")
    return losses


def _bare_driver_loop(device):
    """The driver's step loop without its threads: the same model, weights,
    optimizer and SyntheticLM batches (made on the host beforehand), with
    the driver's per-step reads of loss, lr and grad_norm. ms a step over
    steps 2 to DRIVER_STEPS."""
    cfg = get_config(ARCH)
    model = build_model(cfg, device)
    state = make_train_state(model, torch.Generator().manual_seed(0))
    oc = OptConfig(peak_lr=3e-4, warmup_steps=max(DRIVER_STEPS // 20, 5),
                   total_steps=DRIVER_STEPS)
    step = make_train_step(model, oc)
    src = SyntheticLM(DataConfig(TRAIN_SEQ, TRAIN_BATCH, cfg.vocab_size))
    batches = [src.batch(i) for i in range(DRIVER_STEPS)]
    t0 = None
    for i, b in enumerate(batches):
        batch = {k: torch.as_tensor(v).to(device) for k, v in b.items()}
        state, metrics = step(state, batch)
        float(metrics["loss"]), float(metrics["lr"]), float(metrics["grad_norm"])
        if i == 0:
            t0 = time.perf_counter()
    return (time.perf_counter() - t0) * 1e3 / (DRIVER_STEPS - 1)


def phase_train_driver(device, bare_ms):
    """``repro_torch.launch.train.main`` as a user runs it, for relic_tiny at
    full width on the card: Relic-prefetched batches, DRIVER_STEPS steps,
    without and with checkpoints every DRIVER_CKPT_EVERY steps (the
    serialize and publish stages on the Relic substrate), beside the same
    loop without the driver's threads and phase 8's bare loop. Then the
    chaos pair of tests/test_checkpoint_crash.py:277-307 with its own
    arguments on the card (a crash in the second save's manifest, then
    --resume), holding the state restored onto the card bit for bit
    against the published files."""
    ckpt = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    run = ["--arch", ARCH, "--batch", str(TRAIN_BATCH), "--seq",
           str(TRAIN_SEQ), "--device", device.type, "--steps",
           str(DRIVER_STEPS), "--log-every", "1"]
    try:
        _, plain, _ = _driver(run, "no checkpoints")
        _, saved, _ = _driver(run + ["--ckpt", ckpt, "--ckpt-every",
                                     str(DRIVER_CKPT_EVERY)], "checkpoints")
        losses = _hold_losses("driver", plain, DRIVER_STEPS)
        _hold_losses("driver with checkpoints", saved, DRIVER_STEPS)
        if CheckpointManager(ckpt, async_=False).latest_step() != DRIVER_STEPS:
            raise AssertionError("the last save did not publish")
        shutil.rmtree(ckpt)
        loop_ms = _bare_driver_loop(device)
        ms, ms_ckpt = _driver_ms(plain), _driver_ms(saved)
        print(f"[driver] {ARCH} [{TRAIN_BATCH}, {TRAIN_SEQ}], {DRIVER_STEPS} "
              f"steps, every loss read: {ms:.2f} ms/step without checkpoints, "
              f"{ms_ckpt:.2f} with a checkpoint every {DRIVER_CKPT_EVERY} "
              f"steps; the same loop without the driver's threads "
              f"{loop_ms:.2f} (driver over it {ms / loop_ms:.3f}x); phase 8's "
              f"bare loop {bare_ms:.2f}, reading no loss; losses "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}, all finite")

        # The chaos pair: a crash in the second save's manifest, then --resume.
        chaos = ["--arch", ARCH, "--smoke", "--batch", "4", "--seq", "32",
                 "--log-every", "50", "--ckpt", ckpt, "--ckpt-every", "5",
                 "--steps", "20", "--device", device.type]
        try:
            _driver(chaos + ["--ckpt-chaos", "manifest:1"], "chaos")
        except FsCrash as e:
            print(f"[driver] chaos: the run died mid-save as asked ({e})")
        else:
            raise AssertionError("the chaos run did not crash")
        dirs = sorted(p.name for p in Path(ckpt).glob("step_*"))
        if "step_00000005" not in dirs or "step_00000010" in dirs:
            raise AssertionError(f"after the crash: {dirs}")
        pub = Path(ckpt) / "step_00000005"
        files = {}
        for key, ent in json.loads((pub / "manifest.json").read_text())["entries"].items():
            arr = np.load(pub / ent["file"])
            if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != ent["crc32"]:
                raise AssertionError(f"{key}: published CRC mismatch")
            files[key] = arr
        cfg = get_config(ARCH, smoke=True)
        template = train_state_to_numpy(make_train_state(
            build_model(cfg, device), torch.Generator().manual_seed(0)))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            tree, step = CheckpointManager(ckpt, async_=False).restore(
                template, device=device)
        on_card = train_state_from_numpy(cfg, tree, device)
        if on_card["params"]["embed"]["table"].device.type != device.type:
            raise AssertionError("the restored state is not on the card")
        back = dict(_flat_numpy(train_state_to_numpy(on_card)))
        if step != 5 or set(back) != set(files):
            raise AssertionError(f"restored step {step}, keys differ: "
                                 f"{sorted(set(back) ^ set(files))[:4]}")
        bad = [k for k, a in files.items() if back[k].tobytes() != a.tobytes()]
        if bad:
            raise AssertionError(f"restored state differs from the files: {bad[:4]}")
        print(f"[driver] chaos: step 5 restored onto the card bit-identical to "
              f"its {len(files)} published files")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            loss, _, log = _driver(chaos + ["--resume"], "resume")
        if "resumed from step 5" not in log or not np.isfinite(loss):
            raise AssertionError(f"resume: loss {loss}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return ms, ms_ckpt, loop_ms


def _flat_numpy(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat_numpy(v, key)
        else:
            yield key, np.asarray(v)


def phase_workloads(device, card):
    """The paper's table on the card: each of the nine workloads (its
    instances on their own copies of the paper's inputs) run ``serial``
    and ``fused`` (one batched call) outside any substrate, as the
    reference's harness times its baseline (``benchmarks/run.py:338-343``),
    and ``paired`` and ``chunked`` on a ``relic`` substrate; every result
    through the workload's oracle. WORKLOAD_PASSES passes over all
    workloads, WORKLOAD_REPS timed runs of each variant a pass. Prints µs
    per instance (the median run) and the paired-over-serial speedup, the
    paper's metric."""
    loads = {name: make_workload(name, device=device)
             for name in available_workloads()}
    times = {name: {k: [] for k in ("serial", "paired", "chunked", "fused")}
             for name in loads}

    def timed(w, name, variant, fn, first):
        if first:                          # warm, then hold to the oracle
            w.check(fn())
        for _ in range(WORKLOAD_REPS):
            t0 = time.perf_counter()
            res = fn()
            times[name][variant].append(time.perf_counter() - t0)
            w.check(res)

    for p in range(WORKLOAD_PASSES):
        for name, w in loads.items():
            timed(w, name, "serial", w.serial, p == 0)
            timed(w, name, "fused", lambda: split_instances(
                w.fused_task()(), w.n_instances), p == 0)
            with TaskScope("relic") as scope:
                timed(w, name, "paired", lambda: w.paired(scope), p == 0)
                timed(w, name, "chunked", lambda: w.chunked(scope, grain=1),
                      p == 0)
    bc = loads["bc"]
    device_profile(bc.serial, "workload bc serial, 2 instances")
    with TaskScope("relic") as scope:
        device_profile(lambda: bc.paired(scope), "workload bc paired, 2 instances")
    rows = {}
    for name, w in loads.items():
        us = {k: float(np.median(v)) * 1e6 / w.n_instances
              for k, v in times[name].items()}
        rows[name] = dict(us, speedup=us["serial"] / us["paired"])
        print(f"[workloads] {name}: µs per instance serial {us['serial']:.1f}, "
              f"paired {us['paired']:.1f}, chunked {us['chunked']:.1f}, fused "
              f"{us['fused']:.1f}; paired over serial "
              f"{rows[name]['speedup']:.3f}x ({w.n_instances} instances, "
              f"{WORKLOAD_PASSES} x {WORKLOAD_REPS} runs of each, every "
              f"result through its oracle)")
    print(f"[workloads] on {card}: " + json.dumps(
        {n: {k: round(v, 3) for k, v in r.items()} for n, r in rows.items()}))
    return rows


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
            WKV6_TEST_SHAPES, WKV6_SERVED, WKV6_LONG, torch.bfloat16, 1, device,
            redesign=("tc_launches", lambda r, k, v, w, u: wkv6_k.tc_eligible(r)),
            tc_bound=lambda ins, chunk: wkv6_tc_bound_ms(ins[0], ins[3], ins[4],
                                                         chunk)),
        "ssd": phase_recurrence(
            "ssd", ssd_k, "src/repro/kernels/ssd.py:19", _ssd_inputs,
            lambda ins, chunk: ssd_bound_ms(ins[0], ins[1], ins[2], chunk),
            SSD_TEST_SHAPES, SSD_SERVED, SSD_LONG, torch.float32, 2, device,
            redesign=("tc_launches", lambda x, a, b, c: ssd_k.tc_eligible(x, b)),
            tc_bound=lambda ins, chunk: ssd_tc_bound_ms(ins[0], ins[1], ins[2],
                                                        chunk)),
        "relic_matmul": mm_entry,
        "relic_matmul_gated": gated_entry,
    }
    phase_wkv6_layout(device)
    entries["wkv6"]["design"] = (
        "K = 64 (every rwkv6 call): tensor cores, 3xTF32 mma.sync; decays "
        "between sub-chunks of 16 factored into the operands (exponents <= "
        "0), the clamped pairwise exponential only in the diagonal 16 x 16 "
        "blocks; chunks of 32 loaded by cp.async into a second buffer while "
        "the last computes; a shuffle scan for the cumulative decay; eight "
        "warps, each holding a 16 x 32 block of the state in f32 registers; "
        "the caller's layout, no copy. Other K: one CTA per (b, h), f32 on "
        "the CUDA cores, K padded to a multiple of 4")
    entries["ssd"]["design"] = (
        "f32, P = N = 64 (every zamba2 call): tensor cores, 3xTF32 mma.sync; "
        "one CTA per batch row and pair of heads sharing each chunk's C B^T; "
        "chunks of 32 loaded by cp.async into a second buffer while the last "
        "computes; the state in f32 registers; the caller's layout, no copy. "
        "Other P, N and bf16: one CTA per (b, h), f32 on the CUDA cores")
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
    bare_ms = phase_train(device)
    phase_card_vs_cpu(device)
    _count_path("training", {}, entries)
    torch.cuda.empty_cache()

    # The train driver (prefetched data, async checkpoints, --resume) and
    # the paper's workloads: no kernel launch either.
    _reset_launches()
    t0 = time.perf_counter()
    phase_train_driver(device, bare_ms)
    _count_path("train driver", {}, entries)
    torch.cuda.empty_cache()
    _reset_launches()
    t1 = time.perf_counter()
    phase_workloads(device, card)
    _count_path("workloads", {}, entries)
    print(f"[main] train driver {t1 - t0:.1f} s, workloads "
          f"{time.perf_counter() - t1:.1f} s")

    phase_long(*relic, device)

    print(json.dumps({"kernels": list(entries.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
