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
     one (bf16, head_dim 64, 96, 128 or 256, TMA-describable layouts) is
     held on MHA, GQA and MQA at ragged lengths, Sq != Sk and the model
     layout at every head size, and one ``ops.flash_attention`` call at
     [4, 2048] must run exactly one device kernel and no copy; the
     CUDA-core kernel is held on f32 and every head size it takes. relic_matmul has three designs (``rm.wgmma_eligible``,
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
     (GQA, f32 and bf16; above 256 in slabs of 128 columns; called
     directly, as bf16 at 96 and 256 goes to the wgmma design) and timed
     there; the wgmma design at head_dim 96 and 256 at phi3_mini_3p8b's
     ([8, 32, 192, 96], 32 kv heads) and paligemma_3b's ([8, 8, 192, 256],
     one kv head) attention and at [2, 8, 1024, 96 | 256] (2 kv heads),
     at head_dim 128 at granite_8b's, arctic_480b's,
     qwen3_14b's and llama3_405b's attention (q [8, 32 | 56 | 40 | 128,
     192, 128], 8 kv heads) and at q [4, 32, 2048, 128], each timed beside
     the CUDA-core kernel, and at whisper_large_v3's three (the encoder's
     [8, 20, 1500, 64] and the cross-attention's Sq 192 against Sk 1500,
     non-causal; the decoder's causal [8, 20, 192, 64]), and at head_dim
     224 at zamba2_7b's scoring shape (q [4, 32, 4096, 224], MHA) at its
     softmax scale 112 ** -0.5 (the plain version and SDPA at the same
     scale). The grouped ssd at zamba2_7b's Mamba layer (x [4, 112, 4096,
     64], B and C in 2 groups, f32) through the tensor-core design, held
     against ``ssd_ref`` and bit for bit against a call per group, timed
     beside its bounds (``phase_ssd_grouped``). The RoPE kernel
     (``kernels/rope.py``) bit for bit against ``apply_rope`` in f32 and
     bf16 at phi3_mini_3p8b's [4, 2048] and [8, 192], paligemma_3b's
     [8, 192] and a phi3 decode step at position 8191, timed beside the
     plain chain. Device times come from the profiler beside the
     CUDA-event times;
  3. serve relic_tiny at full width (12 layers, d_model 768) through
     ``repro_torch.launch.serve`` (``load_model`` then ``run``, the two
     parts of its ``main``) plus three more requests through one
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
  7. the other families at full width, each a main path of its own:
     granite_8b (head_dim 128; its 36 layers cut to 18) served
     through ``serve.main``, its teacher-forced forward through 18 launches
     of the wgmma flash design (head_dim 128) at the dense bf16 bars; phi3_mini_3p8b (32
     layers, 32 heads of 96) the same way through 32 launches (head_dim
     96); whisper_large_v3 (32 + 32 layers)
     served (frames -> encode -> cross K/V -> prefill -> decode), its
     forward over the served frames through 96 wgmma launches (encoder,
     decoder and cross-attention; held first at its own shapes in phase
     2), then its loss forward; arctic_480b at full width with its depth cut
     to one layer (the init's shapes and scales, the forward through one
     launch with its routing tables checked, decode against teacher
     forcing drop-free); paligemma_3b served (text), its loss forward
     over 256 patches and 192 tokens with no launch (the prefix path),
     then its text forward over the 192 tokens through 18 wgmma launches
     (head_dim 256) at the dense bf16 bars; zamba2_7b (Zamba2-7B-Instruct
     at full width and depth, 7.357 B parameters drawn as the benchmark
     draws them) one forward over [2, 1024] tokens through exactly 81 ssd
     (tensor-core design), 13 flash (wgmma, head_dim 224) and 13 RoPE
     launches, finite, then timed;
  8. the quickstart path, ``repro_torch.quickstart.main`` at full width: the
     tasking façade, one train step, eight decode steps and one
     ``ops.matmul`` through the relic_matmul kernel;
  9. training relic_tiny at full width (f32 parameters, bf16 compute):
     grad_accum 2 against 1, then 20 steps on one batch with the loss
     falling; five steps with gradient compression beside five without and
     one Adafactor step; then one f32 train step at SMOKE size on the card
     against the same step on the CPU; then rematerialisation
     (``phase_train_remat``, ``cfg.remat``): whisper_large_v3 trained at
     full width and depth (1.58 B f32 parameters, bf16 compute, AdamW) on
     1500 seeded frames beside 448 decoder tokens a row, one step of batch
     2 from the same state under "none", "dots" and "full" (equal losses,
     the bytes the forward holds for the backward full < dots < none), then 10 steps of batch 8
     under its own "full" with the loss falling; relic_tiny's 8 x 256 step
     under "full" and "dots" beside "none";
 10. the train driver, ``repro_torch.launch.train.main``, for relic_tiny at
     full width: 30 steps of Relic-prefetched batches without and with an
     async checkpoint every 10 steps, beside the same loop without the
     driver's threads; then the chaos pair of
     tests/test_checkpoint_crash.py:277-307 (a crash in the second save's
     manifest, then --resume), the state restored onto the card held bit
     for bit against the published files;
 11. the paper's nine workloads (``repro_torch.workloads``) serial and fused
     outside any substrate, paired and chunked on ``relic``, every result
     through its oracle: µs per instance and paired over serial; then the
     paper's strategy comparison (``phase_strategies``): the seven kernels of
     the paper's table under the eight strategies of
     ``repro_torch.tasks.strategies`` (serial, Relic, the lock-and-spin,
     condvar and pool substrates, a thread per task, both dispatches on one
     stream, the fused call), every strategy's results through the oracle,
     the fig1 rows and the fig4 geomeans, then ``python -m
     repro_torch.relic_tasks`` on the card;
 12. the multi-device layer over a one-rank NCCL group (``phase_mesh``, after
     the train driver): a ``(1, 1)`` ``("data", "model")`` mesh; relic_tiny
     at full width trains 3 steps with its state distributed as DTensors
     beside 3 plain steps from the same state (the losses must agree, the
     parameters bit for bit), the Relic rings (``tp_allgather_matmul``,
     ``tp_matmul_reducescatter``, ``mlp_ring``) at its MLP shape against the
     plain products, ``compressed_psum`` of its gradients against
     ``dequantize(quantize(g))``, ``pipeline_apply`` with one stage against
     the sequential stack, a sharded forward with the kernels refused, and
     the distributed state saved and ``elastic_restore``d bit for bit. NCCL
     must initialize; nothing falls back to gloo;
 13. the dry-run (``phase_dryrun``, after the mesh phase):
     ``python -m repro_torch.launch.dryrun`` for granite_8b's train_4k and
     decode_32k cells on the 16 x 16 production mesh (a fake group of 256
     ranks on the host's CPU, meta tensors; every record key present, the
     counts positive); then the dry-run's prediction for relic_tiny at full
     width (the 8 x 256 train step, a batch-8 decode step on a 2048-token
     cache) held against the same steps on the card over a one-rank NCCL
     ``(1, 1)`` mesh: the argument bytes against the allocator's requests
     and ``memory_allocated``'s growth, the FLOPs against
     ``FlopCounterMode`` over the real step, the predicted peak and the
     step time beside the measured ones, the train step under each remat
     policy ("none", "full", "dots"); and the mesh serve step's greedy
     tokens against the plain serve step's, exactly; granite_8b's
     decode_32k record must count below 1e9 collective wire bytes a device
     (split-T keeps each rank's slice of the cache where it is), its
     train_4k record at most the reference's depth-exact count (6.43986e11)
     with a predicted peak of at most 34.79 GB, its three largest call
     sites printed (``--sites``); every family's SMOKE train cell on a
     (4, 2) mesh over a fake group of 8 (``--smoke``), each count within
     0.02% of the torch 2.13 count (every block's plan explicit);
 14. split-T decode and the vocab-parallel log-likelihood at granite_8b's
     full width (``phase_split_decode``, after the dry-run): a decode
     attention over a [8, 32768, 8, 128] bf16 cache at position 30000, its
     time axis cut into 16 slices on the card as the pod's "model" axis
     cuts it, ``attention_partial`` on each and ``combine_partials`` over
     them against ``attention_full``; the log-likelihood of [8, 192, 49152]
     f32 logits cut 16 ways (``vocab_partial``, ``combine_vocab_partials``)
     against ``torch.log_softmax`` and a gather, value and gradient; each
     timed beside the unsplit function;
 15. the port's two device examples as a user runs them
     (``phase_examples``, after the workloads): ``repro_torch.serve_batch``
     (qwen3_14b at SMOKE size) and ``repro_torch.train_lm --steps 20``, their
     tensors on the card;
 16. a long relic_tiny forward and loss at [4, 2048] with the kernel against
     the plain (chunked-attention) path.
Phases 3-4, 5, 6, each family of 7, and 8 are the main paths: each starts
with every kernel's launch count at 0 and its counts are read when it ends
(one RoPE launch a layer of every RoPE family, also in paligemma's prefix
loss); every flash launch there and in phase 16 must go through the wgmma design
(none through the CUDA-core kernel) and every ssd and wkv6 launch through
the tensor-core one, and the
quickstart's one relic_matmul launch through the f32 design; phases 9 to
15 must launch no kernel (training runs the plain paths, as the
reference's does, and the workloads' kernels were never Pallas ones).
On the one-rank mesh the cache's time axis is sharded over a "model" axis
of one: every attention of the mesh serve step must take split-T (phase
13), none the per-head path. The logits' vocab there is held whole by
its one rank, so the mesh train step's loss keeps the single-device
arithmetic (phase 12); the vocab-parallel loss runs on the card in phase
14.

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
import threading
import time
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor.experimental import implicit_replication

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import quickstart, relic_tasks, serve_batch, train_lm  # noqa: E402
from repro_torch import sharding as shd  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, elastic_restore  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.devices import synchronize  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import conv as conv_k  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import relic_matmul as rm  # noqa: E402
from repro_torch.kernels import rope as rope_k  # noqa: E402
from repro_torch.kernels import ssd as ssd_k  # noqa: E402
from repro_torch.kernels import wkv6 as wkv6_k  # noqa: E402
from repro_torch.launch import dryrun, serve, train  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,  # noqa: E402
                                      make_train_state, make_train_step)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba2 as m2  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import rwkv6 as r6  # noqa: E402
from repro_torch.models.convert import (train_state_from_numpy,  # noqa: E402
                                        train_state_to_numpy)
from repro_torch.core import collective_matmul as cm  # noqa: E402
from repro_torch.core.pipeline import pipeline_apply, split_stages  # noqa: E402
from repro_torch.launch.mesh import init_distributed, make_mesh  # noqa: E402
from repro_torch.models.encdec import encdec_loss  # noqa: E402
from repro_torch.models.lm import lm_forward, lm_loss  # noqa: E402
from repro_torch.optim.compression import (compressed_psum,  # noqa: E402
                                           dequantize, quantize)
from repro_torch.optim import (AdafactorConfig, OptConfig,  # noqa: E402
                               adafactor_update, clip_by_global_norm,
                               init_adafactor_state, schedule)
from repro_torch.runtime.chaos import FsCrash  # noqa: E402
from repro_torch.serve import ServeScheduler  # noqa: E402
from repro_torch.tasks.api import TaskScope  # noqa: E402
from repro_torch.tasks.strategies import (STRATEGIES, bench_strategies,  # noqa: E402
                                          fig4_geomeans)
from repro_torch.tasks.streams import lane_stream  # noqa: E402
from repro_torch.workloads import (PAPER_WORKLOADS, available_workloads,  # noqa: E402
                                   make_workload, split_instances)

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
# Its head_dim-128 instance: (b, s, h, kv) at MHA, GQA 4:1 and 7:1 (the
# dense configs' and arctic's ratios) at ragged S, causal and not, and
# Sq 128 against Sk 320.
WGMMA_128_SHAPES = [(2, 200, 4, 4), (2, 200, 8, 2), (2, 200, 7, 1),
                    (1, 1000, 8, 2)]
WGMMA_128_CROSS = (2, 128, 8, 2, 128, 320)
# Its head_dim-96 and -256 instances: (b, s, h, kv) at MHA (phi3_mini's
# ratio), GQA 4:1 and MQA (paligemma's) at ragged S, causal and not, and
# Sq 128 against Sk 320 (b, sq, h, kv, sk).
WGMMA_WIDE_SHAPES = {96: [(2, 200, 4, 4), (2, 200, 8, 2), (1, 1000, 8, 2)],
                     256: [(2, 200, 8, 1), (2, 200, 8, 2), (1, 1000, 8, 1)]}
WGMMA_WIDE_CROSS = (2, 128, 8, 2, 320)
MAIN_SHAPE = (4, 2048, 12, 4, 64)  # relic_tiny's attention in the long forward
LONG_128_SHAPE = (4, 2048, 32, 8, 128)   # granite's heads at [4, 2048]: D=128 bound by operations
# relic_tiny's attention in the teacher-forced forward of the counted main path
TEACHER_SHAPE = (SERVE_BATCH, PROMPT_LEN + GEN, 12, 4, 64)
# zamba2_1p2b's shared attention in its teacher-forced forward (no GQA)
ZAMBA_ATTN_SHAPE = (SERVE_BATCH, PROMPT_LEN + 128, 32, 32, 64)
# Each kernel's launch counter: name -> (module, attribute).
COUNTERS = {"flash_attention": (fa, "launches"), "wkv6": (wkv6_k, "launches"),
            "ssd": (ssd_k, "launches"), "relic_matmul": (rm, "launches"),
            "relic_matmul_gated": (rm, "gated_launches"),
            "rope": (rope_k, "launches"), "conv": (conv_k, "launches")}
# The redesigned designs' counters: name -> (module, attribute), beside the
# kernel's own count in COUNTERS.
REDESIGNS = {"flash_attention": (fa, "wgmma_launches"),
             "relic_matmul": (rm, "wgmma_launches"),
             "relic_matmul_gated": (rm, "gated_wgmma_launches"),
             "ssd": (ssd_k, "tc_launches"),
             "wkv6": (wkv6_k, "tc_launches")}
# Head sizes the CUDA-core flash kernel takes beyond the models' 64: the
# next instance up (48), instances of their own (96 and 256, which bf16
# calls of the models take to the wgmma design) and the slabs of 128
# columns above 256 (320, 512); (b, s, h, kv) GQA 4:1 at a ragged length,
# and the timed shape (the wgmma design is timed there too at 96 and 256).
FMA_HEAD_DIMS = (48, 96, 256, 320, 512)
FMA_HEAD_SHAPE = (2, 200, 8, 2)
FMA_HEAD_TIMED = (2, 1024, 8, 2)
SOURCES = ["flash_attention", "flash_attention_wgmma", "relic_matmul",
           "relic_matmul_wgmma", "ssd", "wkv6", "rope", "conv"]   # csrc/<name>.cu
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
MAIN_PATHS = [(ARCH, GEN, {"flash_attention": 12, "rope": 12}, True),
              ("rwkv6_1p6b", 64, {"wkv6": 24}, False),
              ("zamba2_1p2b", 128, {"ssd": 38, "conv": 38, "flash_attention": 6,
                                    "rope": 6}, False)]
QUICKSTART_LAUNCHES = {"relic_matmul": 1}   # its ops.matmul (quickstart.py)
# The other families at full width, served and forwarded as the paths above
# (batch 8, prompt 128, 64 tokens; the teacher-forced forwards over 192
# tokens). granite_8b is full depth (36 layers, head_dim 128: the wgmma
# design's second instance); whisper_large_v3 full depth (32 + 32 layers, 20 heads of 64
# over 1500 frames: the wgmma design in the encoder, the decoder and its
# cross-attention); paligemma_3b full depth (its image prefix keeps every
# attention off the kernels); arctic_480b full width with its depth cut to
# ARCTIC_LAYERS (128 experts of d_ff 4864 at d_model 7168 are 14.1 B
# parameters a layer, 28.1 GB in bf16), not served through the CLI, which
# takes no depth.
GRANITE, WHISPER, ARCTIC, PALIGEMMA = ("granite_8b", "whisper_large_v3",
                                       "arctic_480b", "paligemma_3b")
PHI3 = "phi3_mini_3p8b"   # full width and depth: 32 layers, 32 heads of 96
ARCTIC_LAYERS = 1
TEXT_LEN = PROMPT_LEN + GEN
GRANITE_ATTN_SHAPE = (SERVE_BATCH, TEXT_LEN, 32, 8, 128)   # (b, s, h, kv, d)
ARCTIC_ATTN_SHAPE = (SERVE_BATCH, TEXT_LEN, 56, 8, 128)    # GQA 7:1
PHI3_ATTN_SHAPE = (SERVE_BATCH, TEXT_LEN, 32, 32, 96)      # MHA at head_dim 96
PALIGEMMA_ATTN_SHAPE = (SERVE_BATCH, TEXT_LEN, 8, 1, 256)  # MQA at head_dim 256
# Zamba2-7B-Instruct (portbench/configs/zamba2_7b.json) at its published
# width and depth: its shared blocks' attention at the zamba2_7b.score_4k
# cell's [4, 4096] (32 heads of 224, the wgmma design's fifth instance) at
# its softmax scale (224 / 2) ** -0.5; its Mamba layers' grouped ssd there
# (b, h, t, p, n, groups, chunk); one forward's launches (81 Mamba layers, 13
# uses of the shared blocks, each with RoPE; a conv launch a Mamba layer)
# over [2, 1024] tokens.
ZAMBA2_7B = "zamba2_7b"
ZAMBA2_7B_ATTN_SHAPE = (4, 4096, 32, 32, 224)
ZAMBA2_7B_SCALE = 112 ** -0.5
SSD_GROUPED = (4, 112, 4096, 64, 64, 2, 256)
ZAMBA2_7B_LAUNCHES = {"ssd": 81, "conv": 81, "flash_attention": 13, "rope": 13}
ZAMBA2_7B_TOKENS = (2, 1024)
# The other head_dim-128 configs' attention at the same [8, 192]: held and
# timed in the kernel phase; their families are on no path of this script.
HEAD_DIM_128_SHAPES = [("qwen3_14b", (SERVE_BATCH, TEXT_LEN, 40, 8, 128)),
                       ("llama3_405b", (SERVE_BATCH, TEXT_LEN, 128, 8, 128))]
# whisper_large_v3's attentions: (label, (b, s, h, kv, d), causal, sk)
WHISPER_ATTN = [("encoder self-attention", (SERVE_BATCH, 1500, 20, 20, 64),
                 False, None),
                ("decoder cross-attention", (SERVE_BATCH, TEXT_LEN, 20, 20, 64),
                 False, 1500),
                ("decoder self-attention", (SERVE_BATCH, TEXT_LEN, 20, 20, 64),
                 True, None)]
# Flash launches of each new path's counted forward: one a layer and
# attention (whisper: 32 encoder, 32 decoder self, 32 cross; paligemma's
# text forward, which has no image prefix), all through the wgmma design.
# granite_8b served at full width with its depth cut 36 -> 18 (its init, one
# host thread drawing 8 B normals, took 58 to 73 s at full depth).
GRANITE_LAYERS = 18
GRANITE_LAUNCHES, WHISPER_LAUNCHES = GRANITE_LAYERS, 96
PHI3_LAUNCHES, PALIGEMMA_TEXT_LAUNCHES = 32, 18
ARCTIC_DECODE = 16   # forced tokens of arctic's decode check
# The RoPE kernel's shapes, (label, (b, s, h, kv, d, decode position)):
# phi3_mini_3p8b's scoring cell [4, 2048] (the benchmark's), phi3's and
# paligemma_3b's teacher-forced forwards [8, 192] at positions 0..191, and a
# phi3 decode step at position 8191. The label's first word is the config
# whose rope_theta is used.
ROPE_SHAPES = [(PHI3, (4, 2048, 32, 32, 96, None)),
               (PHI3, (SERVE_BATCH, TEXT_LEN, 32, 32, 96, None)),
               (PALIGEMMA, (SERVE_BATCH, TEXT_LEN, 8, 1, 256, None)),
               (f"{PHI3} decode", (SERVE_BATCH, 1, 32, 32, 96, 8191))]
# The conv kernel's shapes, (label, (b, s, C, in-projection width, xBC's
# first column, taps, bias)): zamba2_7b's scoring cell [4, 4096] (the
# benchmark's) and zamba2_1p2b's teacher-forced forward [8, 256], each x the
# strided view of xBC in the in-projection's output, as the model reads it.
CONV_SHAPES = [(ZAMBA2_7B, (4, 4096, 7424, 14704, 7168, 4, True)),
               ("zamba2_1p2b", (SERVE_BATCH, PROMPT_LEN + 128, 4224, 8384, 4096,
                                4, False))]
OPTIM_STEPS = 5      # train steps of relic_tiny with gradient compression
# Rematerialisation (``cfg.remat``): whisper_large_v3 trained at full width
# and depth on 1500 frames beside 448 decoder tokens (Whisper's text
# context): one step of batch 2 under each policy, then 10 steps of batch 8
# under its own "full".
REMAT_POLICIES = ("none", "dots", "full")
REMAT_TEXT = 448
REMAT_BATCH, REMAT_STEPS = 8, 10
REMAT_CMP_BATCH = 2
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
MESH_STEPS = 3                 # train steps with DTensor state, and plain
PIPE_SHAPE = (12, 4, 2, 256)   # (layers, microbatches, mb, seq) at 768 wide
WORKLOAD_PASSES, WORKLOAD_REPS = 3, 5   # passes over the workloads; runs a pass
# The paper's strategy comparison: passes over the seven kernels, timed
# iterations and warm-up a row (thread_per_task keeps the reference's floor
# of 100), and the iterations of the relic_tasks example's run.
STRATEGY_PASSES, STRATEGY_ITERS, STRATEGY_WARMUP = 3, 20, 5
RELIC_TASKS_ITERS = 20
LANE_THREADS = 64      # live threads that each take a lane stream


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
    C B^T once per batch row and group (the group's heads share it), and per head W @ x,
    C @ state^T and the state update (the four products), the decay of the
    c(c+1)/2 kept pairs (one exponential each) and the rescalings.
    Returns (product flops, other flops, exponentials, bytes): x, a, b, c
    read once and y written once."""
    bb, h, t, p = x.shape
    n = bmat.shape[-1]
    g = bmat.shape[2] if bmat.dim() == 4 else 1   # b [B, T, G, N]: C B^T a group
    prods = rest = exps = 0
    for c in _chunks(t, chunk):
        pairs = c * (c + 1) // 2
        prods += bb * g * 2 * pairs * n + bb * h * (2 * pairs * p + 4 * c * n * p)
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


def check_kernel(fn, gen, shape, dtype, causal, device, sk=None, scale=None):
    """One flash design (``fn``: ``flash_attention_wgmma`` or
    ``flash_attention_fma``) against the plain version on one seeded input
    of ``shape`` (b, s, h, kv, d), kv length ``sk`` (default s), at softmax
    scale ``scale`` (default d ** -0.5): finite, elementwise at the test
    tolerance and in relative norm. Returns the inputs and the largest
    absolute difference."""
    b, s, h, kv, d = shape
    q, k, v = _qkv(gen, b, s, h, kv, d, dtype, device, sk)
    got = fn(q, k, v, causal=causal, scale=scale)
    want = fa.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    err = _hold(f"{fn.__name__} b{b} s{s}{f' sk{sk}' if sk else ''} h{h} "
                f"kv{kv} d{d} causal={causal}"
                f"{'' if scale is None else f' scale={scale:.6g}'}", got, want,
                TOL[dtype], TOL[dtype])
    return (q, k, v), err


def _launched(counter: str, n: int, fn, label: str):
    """Run ``fn``; ``fa.<counter>`` must rise by exactly ``n``."""
    before = getattr(fa, counter)
    out = fn()
    if getattr(fa, counter) - before != n:
        raise AssertionError(f"{label}: {getattr(fa, counter) - before} "
                             f"{counter}, want {n}")
    return out


@contextlib.contextmanager
def _calls(*targets):
    """Count the calls of ``(module, function name)`` targets while the
    block runs: yields {name: calls}; the functions are restored after."""
    counts = {name: 0 for _, name in targets}
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def counted(name, fn):
        def call(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return call

    for mod, name, fn in saved:
        setattr(mod, name, counted(name, fn))
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def time_flash(label, q, k, v, iters, causal=True, scale=None):
    """The wgmma design at one bf16 shape beside the CUDA-core kernel, the
    plain version, SDPA (the library yardstick, kv heads repeated outside
    the timed call; the port never calls it) and the bound, all at softmax
    scale ``scale`` (default D ** -0.5): CUDA-event times of back-to-back
    calls (at small shapes the host's issue rate) and the profiler's device
    times. Returns the numbers as one dict."""
    h, kv = q.shape[1], k.shape[1]
    k_rep = torch.repeat_interleave(k, h // kv, dim=1)
    v_rep = torch.repeat_interleave(v, h // kv, dim=1)
    ms = time_ms(lambda: fa.flash_attention_wgmma(q, k, v, causal=causal,
                                                  scale=scale), iters)
    fma_ms = time_ms(lambda: fa.flash_attention_fma(q, k, v, causal=causal,
                                                    scale=scale),
                     max(iters // 4, 3))
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal,
                                                        scale=scale),
                       max(iters // 4, 3))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k_rep, v_rep, is_causal=causal, scale=scale), iters)
    device_ms = kernel_ms(lambda: fa.flash_attention_wgmma(q, k, v, causal=causal,
                                                           scale=scale))
    library_device_ms = kernel_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k_rep, v_rep, is_causal=causal, scale=scale))
    bound_ms, bound_by, flops, nbytes = attention_bound_ms(q, k, v, causal)
    shape = (f"q{list(q.shape)} kv{list(k.shape)} bf16 "
             f"{'causal' if causal else 'non-causal'}")
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

    # Its head_dim-128 instance: MHA, GQA 4:1 and 7:1 at ragged S, causal
    # and not; Sq != Sk.
    for b, s, h, kv in WGMMA_128_SHAPES:
        for causal in (True, False):
            check_kernel(fa.flash_attention_wgmma, gen, (b, s, h, kv, 128),
                         dtype, causal, device)
    b, sq, h, kv, d, sk = WGMMA_128_CROSS
    for causal in (True, False):
        check_kernel(fa.flash_attention_wgmma, gen, (b, sq, h, kv, d), dtype,
                     causal, device, sk=sk)

    # Its head_dim-96 and -256 instances: MHA, GQA 4:1 and MQA at ragged S,
    # causal and not; Sq != Sk.
    for d, shapes in WGMMA_WIDE_SHAPES.items():
        for b, s, h, kv in shapes:
            for causal in (True, False):
                check_kernel(fa.flash_attention_wgmma, gen, (b, s, h, kv, d),
                             dtype, causal, device)
        b, sq, h, kv, sk = WGMMA_WIDE_CROSS
        for causal in (True, False):
            check_kernel(fa.flash_attention_wgmma, gen, (b, sq, h, kv, d),
                         dtype, causal, device, sk=sk)

    # The dispatch: bf16 at every head_dim of the wgmma design goes there;
    # f32 and bf16 at other head sizes (32, 80) do not.
    for dt, d, n in ((torch.bfloat16, 64, 1), (torch.bfloat16, 96, 1),
                     (torch.bfloat16, 128, 1), (torch.bfloat16, 224, 1),
                     (torch.bfloat16, 256, 1),
                     (torch.float32, 64, 0), (torch.float32, 96, 0),
                     (torch.float32, 128, 0), (torch.float32, 224, 0),
                     (torch.float32, 256, 0),
                     (torch.bfloat16, 32, 0), (torch.bfloat16, 80, 0)):
        q, k, v = _qkv(gen, 1, 96, 4, 2, d, dt, device)
        got = _launched("wgmma_launches", n, lambda: _launched(
            "launches", 1, lambda: fa.flash_attention_cuda(q, k, v),
            "flash_attention_cuda"), f"flash_attention_cuda {dt} d{d}")
        _hold(f"flash_attention_cuda d{d}", got,
              fa.flash_attention_plain(q, k, v), TOL[dt], TOL[dt])

    # The CUDA-core kernel at head sizes beyond the models' 64, called
    # directly (bf16 at 96 and 256 goes to the wgmma design through
    # flash_attention_cuda): 48 on the next instance up (columns
    # zero-filled on chip), 96 and 256 on their own, 320 and 512 in slabs
    # of 128 columns. At 96 and 256 the wgmma design is timed at the same
    # shape.
    head_dims, wide = [], []
    for d in FMA_HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v = _qkv(gen, *FMA_HEAD_SHAPE, d, dt, device)
                got = _launched("wgmma_launches", 0, lambda: _launched(
                    "launches", 1, lambda: fa.flash_attention_fma(
                        q, k, v, causal=causal), "flash_attention_fma"),
                    f"flash_attention_fma d{d}")
                _hold(f"flash_attention_fma q{list(q.shape)} kv{list(k.shape)} "
                      f"causal={causal} (CUDA-core kernel)", got,
                      fa.flash_attention_plain(q, k, v, causal=causal),
                      TOL[dt], TOL[dt])
        if d in fa.WGMMA_HEAD_DIMS:
            (q, k, v), err = check_kernel(fa.flash_attention_wgmma, gen,
                                          (*FMA_HEAD_TIMED, d), dtype, True,
                                          device)
            wide.append({**time_flash(f"head_dim {d} shape", q, k, v, 20),
                         "max_abs_err": err})
        else:
            q, k, v = _qkv(gen, *FMA_HEAD_TIMED, d, dtype, device)
        head_dims.append(time_fma(q, k, v))

    # ops.flash_attention hands the model layout [B, S, H, D] to the wgmma
    # design as it is, at lengths no multiple of its tiles, at every head
    # size, causal and not.
    for d in fa.WGMMA_HEAD_DIMS:
        for s in (96, 300):
            for causal in (True, False):
                q, k, v = (x.transpose(1, 2).contiguous()
                           for x in _qkv(gen, 1, s, 4, 2, d, dtype, device))
                got = _launched("wgmma_launches", 1, lambda: ops.flash_attention(
                    q, k, v, causal=causal),
                    f"ops.flash_attention at S={s} d{d} causal={causal}")
                want = fa.flash_attention_plain(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=causal).transpose(1, 2)
                _hold(f"ops.flash_attention model layout S={s} d{d} "
                      f"causal={causal}", got, want, TOL[dtype], TOL[dtype])

    (q, k, v), err = check_kernel(fa.flash_attention_wgmma, gen, TEACHER_SHAPE,
                                  dtype, True, device)
    teacher = {**time_flash("teacher-forced shape", q, k, v, 50),
               "max_abs_err": err}
    (q, k, v), err = check_kernel(fa.flash_attention_wgmma, gen,
                                  ZAMBA_ATTN_SHAPE, dtype, True, device)
    zamba = {**time_flash("zamba2 shared-attention shape", q, k, v, 50),
             "max_abs_err": err}
    # The head_dim-128 configs' attention (the wgmma design's second
    # instance; granite_8b GQA 4:1, arctic_480b 7:1, qwen3_14b 5:1,
    # llama3_405b 16:1) and whisper_large_v3's (20 heads, 1500 frames, Sq
    # 192 against Sk 1500), each held against the plain version before a
    # path relies on it, and timed beside the CUDA-core kernel.
    d128 = []
    for path, shape in ((GRANITE, GRANITE_ATTN_SHAPE), (ARCTIC, ARCTIC_ATTN_SHAPE),
                        *HEAD_DIM_128_SHAPES):
        (q, k, v), err = check_kernel(fa.flash_attention_wgmma, gen, shape,
                                      dtype, True, device)
        d128.append({**time_flash(f"{path} attention", q, k, v, 20),
                     "max_abs_err": err, "path": path})
    (q, k, v), err = check_kernel(fa.flash_attention_wgmma, gen, LONG_128_SHAPE,
                                  dtype, True, device)
    d128.append({**time_flash("long head_dim-128 shape", q, k, v, 20),
                 "max_abs_err": err})
    # phi3_mini's MHA at head_dim 96 and paligemma's MQA at head_dim 256
    # (the design's third and fourth instances), held and timed before
    # their paths rely on them.
    for path, shape in ((PHI3, PHI3_ATTN_SHAPE), (PALIGEMMA, PALIGEMMA_ATTN_SHAPE)):
        (q, k, v), err = check_kernel(fa.flash_attention_wgmma, gen, shape,
                                      dtype, True, device)
        wide.append({**time_flash(f"{path} attention", q, k, v, 20),
                     "max_abs_err": err, "path": path})
    # Zamba2-7B's shared attention at head_dim 224 (the fifth instance) at
    # its scoring cell's shape and softmax scale, held and timed before its
    # path relies on it.
    del q, k, v
    (q, k, v), err = check_kernel(fa.flash_attention_wgmma, gen,
                                  ZAMBA2_7B_ATTN_SHAPE, dtype, True, device,
                                  scale=ZAMBA2_7B_SCALE)
    wide.append({**time_flash(f"{ZAMBA2_7B} attention", q, k, v, 20,
                              scale=ZAMBA2_7B_SCALE),
                 "max_abs_err": err, "path": ZAMBA2_7B,
                 "scale": ZAMBA2_7B_SCALE})
    del q, k, v
    torch.cuda.empty_cache()
    whisper = []
    for label, shape, causal, sk in WHISPER_ATTN:
        (q, k, v), err = check_kernel(fa.flash_attention_wgmma, gen, shape,
                                      dtype, causal, device, sk=sk)
        whisper.append({**time_flash(f"{WHISPER} {label}", q, k, v, 20,
                                     causal=causal),
                        "max_abs_err": err, "path": WHISPER})
    del q, k, v
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
                       "caller's strides, one box per 64-column swizzle "
                       "atom; bf16, one template with instances at D=64, "
                       "96 (two atoms, the second half zero-filled by TMA), "
                       "128, 224 and 256 (64-row kv tiles, O out through "
                       "the q tile; at 224 the fourth atom half filled by "
                       "TMA's zeros); a softmax scale of the caller's. f32, "
                       "every other D "
                       "(instances 16/32/64/96/128/256, the next one up for "
                       "any other up to 256, slabs of 128 columns above) and "
                       "non-TMA layouts: "
                       "src/repro_torch/kernels/csrc/flash_attention.cu"),
            "launches": None, "max_abs_err": max_err, **main,
            "other_shapes": [teacher, zamba, *d128, *wide, *whisper],
            "head_dims": head_dims}


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


def _ssd_inputs(gen, b, h, t, p, n, dtype, device, groups=1):
    """Seeded x [b, h, t, p], a [b, h, t] and b, c [b, t, n], or [b, t,
    groups, n] where ``groups`` > 1."""
    def mk(*shape):
        return torch.randn(shape, generator=gen)
    x = mk(b, h, t, p).to(device=device, dtype=dtype)
    a = (-mk(b, h, t).abs() * 0.5).to(device)
    bc = (b, t, n) if groups == 1 else (b, t, groups, n)
    return x, a, mk(*bc).to(device), mk(*bc).to(device)


def _ulps(got, want) -> int:
    """The largest gap between two tensors of one float dtype in units in
    the last place: their bit patterns as integers in the order of the
    values."""
    it, mag = ((torch.int16, 0x7FFF) if got.dtype == torch.bfloat16
               else (torch.int32, 0x7FFFFFFF))

    def ordered(t):
        i = t.contiguous().view(it).long()
        return torch.where(i < 0, -(i & mag), i)
    return int((ordered(got) - ordered(want)).abs().max().item())


@torch.no_grad()
def phase_rope(device):
    """The RoPE kernel against apply_rope, its plain version, at each of
    ROPE_SHAPES in f32 and bf16: one launch a call and the same bits (the
    largest gap in units in the last place printed; it must be 0). In bf16
    its device time beside the plain chain's and the bound: q and k read
    once and written once. Returns the kernel's entry of the numbers line
    (its numbers at phi3's scoring shape first)."""
    gen = torch.Generator().manual_seed(5)
    timed = []
    for label, (b, s, h, kv, d, at) in ROPE_SHAPES:
        theta = get_config(label.split()[0]).rope_theta
        pos = (torch.arange(s, device=device)[None, :] if at is None
               else torch.full((b, 1), at, device=device))
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, s, h, d), generator=gen).to(device, dtype)
            k = torch.randn((b, s, kv, d), generator=gen).to(device, dtype)
            before = rope_k.launches
            got = rope_k.rope_cuda(q, k, pos, theta)
            want = rope_k.rope_plain(q, k, pos, theta)
            torch.cuda.synchronize()
            gap = max(_ulps(g, w) for g, w in zip(got, want))
            print(f"[kernel] rope {label} q{list(q.shape)} k{list(k.shape)} "
                  f"{str(dtype)[6:]}: {rope_k.launches - before} launch, "
                  f"largest gap from apply_rope {gap} ulps")
            if rope_k.launches - before != 1 or gap:
                raise AssertionError(f"rope {label} {dtype}: "
                                     f"{rope_k.launches - before} launches, "
                                     f"{gap} ulps from apply_rope")
        ms = time_ms(lambda: rope_k.rope_cuda(q, k, pos, theta), 20)
        device_ms = kernel_ms(lambda: rope_k.rope_cuda(q, k, pos, theta))
        plain_ms = time_ms(lambda: rope_k.rope_plain(q, k, pos, theta), 5)
        plain_device_ms = kernel_ms(lambda: rope_k.rope_plain(q, k, pos, theta), 5)
        nbytes = 2 * (q.nbytes + k.nbytes)
        bound_ms = nbytes / PEAK_BYTES_S * 1e3

        def fmt(x):
            return "not measured" if x is None else f"{x:.4f} ms"
        shape = f"q{list(q.shape)} k{list(k.shape)} bf16"
        rate = "" if device_ms is None else \
            f", {nbytes / device_ms / 1e6:.0f} GB/s"
        print(f"[kernel] rope {label} {shape}: kernel {ms:.4f} ms (device "
              f"{fmt(device_ms)}{rate}), plain chain {plain_ms:.4f} ms "
              f"(device {fmt(plain_device_ms)}); bound {bound_ms:.4f} ms by "
              f"bytes ({nbytes / 1e6:.2f} MB)")
        timed.append(dict(shape=shape, path=label, ms=ms, device_ms=device_ms,
                          plain_ms=plain_ms, plain_device_ms=plain_device_ms,
                          bound_ms=bound_ms, bound_by="bytes"))
    return {"name": "rope", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rope.cu",
            "replaces": None,
            "design": ("q and k of a layer in one launch; a CTA per tile of "
                       "tokens computes cos and sin once per token and "
                       "frequency into shared memory, then rotates every head "
                       "of q and k with 16-byte loads and stores, f32 in "
                       "registers, each product and sum rounded on its own "
                       "(apply_rope's bits)"),
            "launches": None, "max_ulps": 0, **timed[0],
            "other_shapes": timed[1:], "library_ms": None}


def phase_conv(device):
    """The conv kernel against _causal_conv, its plain version, at each of
    CONV_SHAPES in f32 and bf16, x read from the strided view: one launch a
    call and the same bits (the largest gap in units in the last place
    printed; it must be 0). In bf16 its device time beside the eager
    chain's and the bound: x read once and the output written once, the
    taps and the bias once. Returns the kernel's entry of the numbers line
    (its numbers at zamba2_7b's cell shape first)."""
    gen = torch.Generator(device=device).manual_seed(6)

    def rnd(*shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=device)).to(dtype)

    timed = []
    for label, (b, s, c, width, col, k, has_bias) in CONV_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = rnd(b, s, width, dtype=dtype)[:, :, col:col + c]
            w = rnd(k, c, dtype=dtype, scale=0.5)
            bias = rnd(c, dtype=dtype, scale=0.1) if has_bias else None
            before = conv_k.launches
            got = conv_k.causal_conv_silu_cuda(x, w, bias)
            want = conv_k.causal_conv_silu_plain(x, w, bias)
            torch.cuda.synchronize()
            gap = _ulps(got, want)
            shape = (f"x{list(x.shape)} of [{b}, {s}, {width}] at column {col}, "
                     f"{k} taps{', bias' if has_bias else ''}")
            print(f"[kernel] conv {label} {shape} {str(dtype)[6:]}: "
                  f"{conv_k.launches - before} launch, largest gap from "
                  f"_causal_conv {gap} ulps")
            if conv_k.launches - before != 1 or gap:
                raise AssertionError(f"conv {label} {dtype}: "
                                     f"{conv_k.launches - before} launches, "
                                     f"{gap} ulps from _causal_conv")
            del got, want

        def call():
            return conv_k.causal_conv_silu_cuda(x, w, bias)

        def plain():
            return conv_k.causal_conv_silu_plain(x, w, bias)
        ms = time_ms(call, 20)
        device_ms = kernel_ms(call)
        plain_ms = time_ms(plain, 5)
        plain_device_ms = kernel_ms(plain, 5)
        nbytes = (2 * x.numel() + w.numel() + c * has_bias) * x.element_size()
        bound_ms = nbytes / PEAK_BYTES_S * 1e3

        def fmt(v):
            return "not measured" if v is None else f"{v:.4f} ms"
        rate = "" if device_ms is None else \
            f", {nbytes / device_ms / 1e6:.0f} GB/s"
        print(f"[kernel] conv {label} {shape} bf16: kernel {ms:.4f} ms (device "
              f"{fmt(device_ms)}{rate}), eager chain {plain_ms:.4f} ms (device "
              f"{fmt(plain_device_ms)}); bound {bound_ms:.4f} ms by bytes "
              f"({nbytes / 1e6:.2f} MB)")
        timed.append(dict(shape=f"{shape} bf16", path=label, ms=ms,
                          device_ms=device_ms, plain_ms=plain_ms,
                          plain_device_ms=plain_device_ms, bound_ms=bound_ms,
                          bound_by="bytes"))
        del x, w, bias
    return {"name": "conv", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/conv.cu",
            "replaces": None,
            "design": ("the Mamba-2 layers' depthwise causal conv, its bias and "
                       "SiLU in one launch, x read where it lies in the "
                       "in-projection's output; a thread owns 8 bytes of "
                       "channels over a run of 16 tokens, the last K - 1 "
                       "inputs, the taps and the bias in registers, the next "
                       "4 tokens' loads issued before these 4 compute; each "
                       "product and sum rounded on its own (bf16x2 "
                       "instructions in bf16), SiLU in f32 (_causal_conv's "
                       "bits)"),
            "launches": None, "max_ulps": 0, **timed[0],
            "other_shapes": timed[1:], "library_ms": None}


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


@torch.no_grad()
def phase_ssd_grouped(device):
    """The ssd with B and C in groups at Zamba2-7B's Mamba layer
    (``SSD_GROUPED``: x [4, 112, 4096, 64], 2 groups of 56 heads, f32): one
    launch through the tensor-core design, held against ``ssd_ref`` and bit
    for bit against a call per group on its heads; timed beside the plain
    version and both bounds. Returns its numbers."""
    b, h, t, p, n, g, chunk = SSD_GROUPED
    gen = torch.Generator().manual_seed(3)
    ins = _ssd_inputs(gen, b, h, t, p, n, torch.float32, device, groups=g)
    x, a, bm, cm = ins
    before = (ssd_k.launches, ssd_k.tc_launches)
    got = ssd_k.ssd_cuda(*ins, chunk=chunk)
    rose = (ssd_k.launches - before[0], ssd_k.tc_launches - before[1])
    if rose != (1, 1):
        raise AssertionError(f"grouped ssd: (launches, tc_launches) rose by "
                             f"{rose}, want (1, 1)")
    shape = f"x{list(x.shape)} b/c{list(bm.shape)} f32 chunk {chunk}"
    err = _hold(f"ssd grouped {shape}", got, ssd_k.ssd_plain(*ins),
                *REC_TOL[torch.float32])
    hg = h // g
    for i in range(g):
        hs = slice(i * hg, (i + 1) * hg)
        one = ssd_k.ssd_cuda(x[:, hs], a[:, hs], bm[:, :, i], cm[:, :, i],
                             chunk=chunk)
        if not torch.equal(one, got[:, hs]):
            raise AssertionError(f"grouped ssd: group {i} differs from a call "
                                 f"on its heads alone")
    ms = time_ms(lambda: ssd_k.ssd_cuda(*ins, chunk=chunk), 10)
    device_ms = kernel_ms(lambda: ssd_k.ssd_cuda(*ins, chunk=chunk), 10)
    plain_ms = time_ms(lambda: ssd_k.ssd_plain(*ins), 1, warmup=1)
    bound_ms, bound_by, flops, exps, nbytes = ssd_bound_ms(x, a, bm, chunk)
    tc_ms, tc_by = ssd_tc_bound_ms(x, a, bm, chunk)
    dev = "not measured" if device_ms is None else f"{device_ms:.4f} ms"
    print(f"[kernel] ssd grouped {shape} ({ZAMBA2_7B}): kernel {ms:.4f} ms "
          f"(device {dev}), plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
          f"by {bound_by}, with the products on the tensor cores in 3xTF32 "
          f"{tc_ms:.4f} ms by {tc_by} ({flops / 1e9:.3f} GFLOP, "
          f"{exps / 1e9:.4f} G exponentials, {nbytes / 1e6:.2f} MB); each "
          f"group bit for bit a call on its heads")
    return dict(shape=shape, max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                tc_bound_ms=tc_ms, tc_bound_by=tc_by, path=ZAMBA2_7B)


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
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    print(f"[serve] {cfg.name}: decode step outside the scheduler, batch "
          f"{SERVE_BATCH}: {ms:.2f} ms/step")
    device_profile(decode, f"{cfg.name}: {n_steps} decode steps, batch "
                           f"{SERVE_BATCH}")
    return ms


def serve_main(arch, gen, device, n_layers=None):
    """``serve.main`` as a user runs it, at full width, in its two parts:
    ``serve.load_model`` (timed here: the weights drawn from the host
    generator, then moved to the card) and ``serve.run``. Returns the
    served tokens, the (cfg, model, params) it served with, so the checks
    that follow run on the served weights without drawing them again, and
    {"init_s", "encode_ms", "prefill_ms", "handoff_ms", "ttft_ms",
    "ms_per_step"}: the time to the first token is the encode (whisper),
    the prefill and the scheduler's hand-off."""
    argv = ["--arch", arch, "--batch", str(SERVE_BATCH), "--prompt-len",
            str(PROMPT_LEN), "--gen", str(gen), "--device", device.type]
    args = serve.parse_args(argv)
    t0 = time.perf_counter()
    cfg, model, params = serve.load_model(arch, smoke=False, device=device,
                                          n_layers=n_layers)
    synchronize(device)
    init_s = time.perf_counter() - t0
    gen_toks, st = serve.run(args, cfg, model, params, device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[serve] {arch} ({' '.join(argv)}): init {init_s:.1f} s "
          f"({n_params / 1e9:.3f} B parameters, {n_params * 2 / 1e9:.2f} GB in "
          f"bf16, drawn from torch.Generator().manual_seed(0) on the host); "
          f"{st['ms_per_step']:.2f} ms/step, {st['tok_s']:.1f} tok/s; time to "
          f"first token {st['ttft_ms']:.1f} ms = encode {st['encode_ms']:.1f} + "
          f"prefill {st['prefill_ms']:.1f} + scheduler hand-off "
          f"{st['handoff_ms']:.2f} ms")
    if tuple(gen_toks.shape) != (SERVE_BATCH, gen):
        raise AssertionError(f"served shape {tuple(gen_toks.shape)}")
    return gen_toks, (cfg, model, params), {
        "init_s": init_s, **{k: st[k] for k in (
            "encode_ms", "prefill_ms", "handoff_ms", "ttft_ms", "ms_per_step")}}


def phase_serve(device):
    # Then three more requests on the served weights through one
    # scheduler, each prefilling inside its work function so its TTFT
    # covers the prefill.
    gen_toks, (cfg, model, params), _ = serve_main(ARCH, GEN, device)
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
    count}); every ssd and wkv6 launch must take its redesigned design
    (tensor cores), every flash launch the wgmma one, and no relic_matmul
    launch the wgmma one (the only product on a main path, the
    quickstart's, is f32). The counts are added to the kernels' entries of
    the numbers line, in total and by path."""
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
    for name, entry in entries.items():
        entry["launches"] += got.get(name, 0)
        entry.setdefault("launches_by_path", {})[label] = got.get(name, 0)
    for name, count in redesigned.items():
        entries[name]["redesign_launches"] = (
            entries[name].get("redesign_launches", 0) + count)


def _forward(cfg, params, tokens, extra=None):
    """(logits, aux) of ``Model.forward``: ``extra`` is the
    encoder-decoder's frames (required) or the VLM's patches (a prefix)."""
    return build_model(cfg, tokens.device).forward(
        params, tokens, *(() if extra is None else (extra,)))


def _timed_forward(cfg, params, tokens, extra=None):
    """(logits, ms): one warm call, then one timed on the host clock."""
    _forward(cfg, params, tokens, extra)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = _forward(cfg, params, tokens, extra)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _rel(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def _agree(logits_a, logits_b) -> float:
    return (logits_a.argmax(-1) == logits_b.argmax(-1)).float().mean().item()


@torch.no_grad()
def phase_forward(cfg, params, gen_toks, want, bf16_bar, device, extra=None):
    """The teacher-forced forward over prompt plus served tokens with the
    kernels (bf16, as served; the encoder-decoder over ``extra``, the served
    frames): exactly ``want`` launches ({kernel: count}); where
    ``bf16_bar``, logits within MODEL_TOL of the plain forward and greedy
    agreement with the served tokens above 0.9. Returns (tokens, kernel
    logits, plain logits)."""
    gen = gen_toks.shape[1]
    prompts = serve.make_prompts(cfg, SERVE_BATCH, PROMPT_LEN, device)
    tokens = torch.cat([prompts, gen_toks], dim=1)
    cfg_k = cfg.replace(use_kernels=True)
    before = _launches()
    logits_k, _ = _forward(cfg_k, params, tokens, extra)
    torch.cuda.synchronize()
    got = {n: c - before[n] for n, c in _launches().items() if c != before[n]}
    if got != want:
        raise AssertionError(f"{cfg.name}: kernel launches {got}, want {want}")
    logits_p, _ = _forward(cfg, params, tokens, extra)
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
def time_forwards(cfg, params, tokens, extra=None):
    """The teacher-forced forward with the kernels and the plain one, timed
    outside the counted main path, and the kernel forward's device time
    under the profiler."""
    cfg_k = cfg.replace(use_kernels=True)
    _, ms_k = _timed_forward(cfg_k, params, tokens, extra)
    _, ms_p = _timed_forward(cfg, params, tokens, extra)
    print(f"[forward] {cfg.name} tokens {list(tokens.shape)}: forward with "
          f"kernels {ms_k:.2f} ms, plain {ms_p:.2f} ms")
    device_profile(lambda: _forward(cfg_k, params, tokens, extra),
                   f"{cfg.name} forward {list(tokens.shape)} with the kernels")
    return {"forward_ms": ms_k, "plain_forward_ms": ms_p}


def phase_recurrent(arch, gen, device):
    """Serve a recurrent family at full width; returns (cfg, params, served
    tokens)."""
    gen_toks, (cfg, model, params), _ = serve_main(arch, gen, device)
    cache = model.init_cache(SERVE_BATCH, PROMPT_LEN + gen)
    state_bytes = sum(t.nbytes for t in _tensors(cache))
    print(f"[serve] {cfg.name}: decode cache at batch {SERVE_BATCH} "
          f"{state_bytes / 1e9:.3f} GB")
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


def phase_mesh(device, card):
    """The multi-device layer on the card, over a one-rank NCCL group (the
    machine has one card): the same code a job of ranks runs, at relic_tiny's
    full width. Returns the DTensor and plain ms a train step."""
    init_distributed(device)   # NCCL, eagerly: a broken NCCL fails here
    if torch.distributed.get_backend() != "nccl":
        raise AssertionError("the mesh phase must run over NCCL")
    mesh = make_mesh((1, 1), ("data", "model"), device)
    try:
        return _mesh_checks(device, card, mesh)
    finally:
        torch.distributed.destroy_process_group()


def _mesh_checks(device, card, mesh):
    cfg = get_config(ARCH)
    model = build_model(cfg, device)
    plain = make_train_state(model, torch.Generator().manual_seed(0))
    dstate = shd.distribute_state(plain, mesh)
    batches = [_train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, s, device)
               for s in range(MESH_STEPS)]
    runs, loss_calls = {}, {}
    for label, state, step in (
            ("DTensor", dstate, make_train_step(model, TRAIN_OC, mesh=mesh)),
            ("plain", plain, make_train_step(model, TRAIN_OC))):
        losses = []
        with _calls((L, "combine_vocab_partials")) as calls:
            for i, batch in enumerate(batches):
                if i == 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (MESH_STEPS - 1)
        runs[label] = (state, losses, ms)
        loss_calls[label] = calls["combine_vocab_partials"]
    # the DTensor step's vocab is "sharded" over a "model" axis of one rank,
    # which holds it whole: its loss keeps the single-device arithmetic
    # (models/layers.py::log_likelihood), bit for bit the plain step's
    if loss_calls != {"DTensor": 0, "plain": 0}:
        raise AssertionError(f"[mesh] vocab-parallel loss calls {loss_calls}"
                             f" on a vocab one rank holds whole")
    (dstate, dl, dms), (plain, pl, pms) = runs["DTensor"], runs["plain"]
    full = shd.full_state(dstate)
    worst = 0.0
    for name, p in plain["params"].named_parameters():
        q = full["params"].get_parameter(name)
        if not torch.allclose(q, p, rtol=1e-4, atol=1e-6):
            raise AssertionError(f"[mesh] parameter {name} differs after "
                                 f"{MESH_STEPS} steps")
        worst = max(worst, (q - p).abs().max().item())
    if not np.allclose(dl, pl, rtol=1e-5, atol=0):
        raise AssertionError(f"[mesh] losses differ: {dl} against {pl}")
    # one rank moves nothing: the sharded step keeps DTensor's plan, whose
    # ops are the plain step's (``sharding.spread``), bit for bit
    if worst != 0.0:
        raise AssertionError(f"[mesh] the one-rank step's parameters differ "
                             f"from the plain step's by up to {worst:.3g}")
    print(f"[mesh] {cfg.name} on a (1, 1) data x model mesh over NCCL, "
          f"batch [{TRAIN_BATCH}, {TRAIN_SEQ}], {MESH_STEPS} steps: DTensor "
          f"{dms:.2f} ms/step, plain {pms:.2f} ms/step over steps 2-"
          f"{MESH_STEPS} ({dms / pms:.2f}x); losses {dl} against {pl}; "
          f"largest parameter difference {worst:.3g} (tol 1e-4 relative + "
          f"1e-6); the DTensor loss over the whole vocab of its one rank; "
          f"{card}")

    # The Relic rings at relic_tiny's MLP shape (bf16), against the plain
    # products; one rank moves nothing, so this is the rings' own cost.
    gen = torch.Generator().manual_seed(0)
    d, f, b, s = cfg.d_model, cfg.d_ff, TRAIN_BATCH, TRAIN_SEQ

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(
            device=device, dtype=torch.bfloat16)

    x = rnd(b, s, d)
    wg, wu = rnd(d, f, scale=d ** -0.5), rnd(d, f, scale=d ** -0.5)
    wd = rnd(f, d, scale=f ** -0.5)
    x2 = x.reshape(b * s, d)
    h = torch.nn.functional.silu(x2 @ wg) * (x2 @ wu)
    cases = [
        ("tp_allgather_matmul", lambda: cm.tp_allgather_matmul(x2, wg, mesh),
         lambda: x2 @ wg),
        ("tp_matmul_reducescatter",
         lambda: cm.tp_matmul_reducescatter(h, wd, mesh), lambda: h @ wd),
        ("mlp_ring", lambda: cm.mlp_ring(cfg.act, x, wg, wu, wd, mesh),
         lambda: ((torch.nn.functional.silu(x2 @ wg) * (x2 @ wu)) @ wd
                  ).reshape(b, s, d)),
    ]
    with torch.no_grad():
        for name, ring, want in cases:
            err = _rel(ring().full_tensor().float(), want().float())
            ring_ms, plain_ms = time_ms(ring, 20), time_ms(want, 20)
            print(f"[mesh] {name} at x [{b * s}, {d}], w [{d}, {f}] / "
                  f"[{f}, {d}] bf16: {ring_ms:.4f} ms against the plain "
                  f"product's {plain_ms:.4f} ms, relative error {err:.3g} "
                  f"(tol {REL_TOL}); {card}")
            if not err < REL_TOL:
                raise AssertionError(f"[mesh] {name} disagrees: {err}")

    # compressed_psum of the gradient leaves over NCCL: one member's sum is
    # its own dequantized levels, exactly.
    params = plain["params"]
    params.zero_grad(set_to_none=True)
    loss, _ = model.loss(params, batches[0])
    loss.backward()
    grads = {n: p.grad.detach() for n, p in params.named_parameters()}
    params.zero_grad(set_to_none=True)
    group = mesh.get_group("data")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summed = {n: compressed_psum(g, group) for n, g in grads.items()}
    torch.cuda.synchronize()
    cp_ms = (time.perf_counter() - t0) * 1e3
    for n, g in grads.items():
        q, sc, k = quantize(g)
        if not torch.equal(summed[n], dequantize(q, sc, k, g.shape, g.dtype)):
            raise AssertionError(f"[mesh] compressed_psum of {n} differs")
    print(f"[mesh] compressed_psum of {len(grads)} gradient leaves "
          f"({sum(g.numel() for g in grads.values()) / 1e6:.1f} M values) "
          f"over NCCL: {cp_ms:.2f} ms host-clocked, each equal to "
          f"dequantize(quantize(g)); {card}")

    # GPipe with one stage against the sequential stack, forward and grads.
    n_layers, m, mb, seq = PIPE_SHAPE
    pod = make_mesh((1,), ("pod",), device)
    ws = (torch.randn((n_layers, d, d), generator=gen) * d ** -0.5).to(device)
    xm = torch.randn((m, mb, seq, d), generator=gen).to(device)

    def stage_fn(stage_ws, hh):
        for w_ in stage_ws:
            hh = torch.tanh(hh @ w_)
        return hh

    stages = split_stages(ws, 1).clone().requires_grad_(True)
    out = pipeline_apply(stage_fn, stages, xm, pod)
    (out ** 2).sum().backward()
    wseq = ws.clone().requires_grad_(True)
    # the stack microbatch by microbatch, at the pipeline's product shapes
    # (cuBLAS picks its algorithm by shape, and so its rounding)
    want = torch.stack([stage_fn(wseq, xm[i]) for i in range(m)])
    (want ** 2).sum().backward()
    fwd = (out - want).abs().max().item()
    # the weight gradients sum the microbatches in another order
    grad = _rel(stages.grad.reshape(ws.shape), wseq.grad)
    print(f"[mesh] pipeline_apply, 1 stage of {n_layers} layers, {m} "
          f"microbatches [{mb}, {seq}, {d}] f32: forward {fwd:.3g} (tol "
          f"1e-6), gradients' relative error {grad:.3g} (tol 1e-5) from the "
          f"sequential stack; {card}")
    if not (fwd < 1e-6 and grad < 1e-5):
        raise AssertionError("[mesh] pipeline_apply disagrees")

    # A sharded forward with the kernels raises (they take no DTensor).
    kcfg = get_config(ARCH, smoke=True).replace(use_kernels=True)
    kmodel = build_model(kcfg, device)
    kparams = shd.distribute_params(
        kmodel.init(torch.Generator().manual_seed(0)), mesh)
    toks = _train_batch(kcfg, 2, 64, 0, device)["tokens"]
    try:
        with torch.no_grad(), shd.use_sharding_rules(mesh), \
                implicit_replication():
            kmodel.forward(kparams, shd.shard_batch({"t": toks}, mesh)["t"])
    except RuntimeError as e:
        if "takes no DTensor" not in str(e):
            raise
        print(f"[mesh] a sharded forward with the kernels raises: {e}")
    else:
        raise AssertionError("[mesh] a sharded forward ran the kernels")

    # The distributed state saved, then restored onto the mesh bit for bit.
    ckpt = Path(ROOT) / "build" / "chip_smoke_mesh_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        mgr = CheckpointManager(ckpt)
        mgr.save(train_state_to_numpy(dstate), MESH_STEPS, block=True)
        back, at = elastic_restore(mgr, dstate, mesh)
        mgr.close()
        again = shd.full_state(back)
        same = at == MESH_STEPS and all(
            torch.equal(again["params"].get_parameter(n), p)
            for n, p in full["params"].named_parameters()) and all(
            torch.equal(again["opt"][k][n], t)
            for k in full["opt"] for n, t in full["opt"][k].items())
        print(f"[mesh] distributed state saved at step {at} and restored "
              f"onto the mesh on the card: bit for bit {same}; {card}")
        if not same:
            raise AssertionError("[mesh] the restored state differs")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return dms, pms


DRYRUN_CELLS = ("train_4k", "decode_32k")   # granite_8b on the pod mesh
DRYRUN_KEYS = ("memory", "per_device", "model_flops_global",
               "useful_flops_ratio", "roofline_terms_s", "dominant", "method")
DRYRUN_DECODE_LEN = 2048   # the card check's cache length (batch 8)
DRYRUN_TOKENS = 8          # decode steps of the mesh-vs-plain token check
# granite_8b decode_32k on the pod mesh: 3.66e10 with the cache gathered
DRYRUN_DECODE_WIRE_MAX = 1e9
# granite_8b train_4k on the pod mesh: the reference's depth-exact
# collective wire bytes a device (``repro.launch.dryrun._cost_points``:
# granite_8b lowered unrolled at 2 and 3 layers and extrapolated to 36;
# jax 0.9.0 on a CPU), and the port's predicted peak bytes a device before
# its train step's collective plan was made explicit (1.190577e12 wire bytes
# then)
DRYRUN_TRAIN_WIRE_MAX = 6.43986e11
DRYRUN_TRAIN_PEAK_MAX = 34.79e9
# Every family's SMOKE train cell (``dryrun.SMOKE_CELL`` on a (4, 2) mesh
# over a fake group of 8): collective wire bytes a device with torch 2.13
# on a CPU (``python -m repro_torch.launch.dryrun --smoke``). Every block's
# plan is explicit, so the card host's release must count the same within
# ``DRYRUN_SMOKE_REL``.
DRYRUN_SMOKE_WIRE_213 = {
    "whisper_large_v3": 1193896,
    "llama4_maverick_400b_a17b": 1757944,
    "arctic_480b": 1499896,
    "granite_8b": 760360,
    "phi3_mini_3p8b": 773672,
    "llama3_405b": 1097256,
    "qwen3_14b": 761000,
    "rwkv6_1p6b": 992546,
    "zamba2_1p2b": 1845592,
    "paligemma_3b": 726376,
    "relic_tiny": 568872,
}
DRYRUN_SMOKE_REL = 2e-4


def _dryrun_records():
    """``python -m repro_torch.launch.dryrun`` for granite_8b's two cells on
    the 16 x 16 production mesh (a fake group of 256 ranks on this host's
    CPU, meta tensors; one process each, run together; train_4k with its
    collective bytes by call site): each record must hold every key, and
    positive FLOPs, bytes and collective bytes; beside them, in a third
    process, every family's SMOKE train cell (``--smoke``). Returns
    ({shape: record}, {arch: SMOKE collective wire bytes a device})."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    procs = {shape: subprocess.Popen(
        cmd + ["--arch", "granite_8b", "--shape", shape, "--mesh", "pod",
               "--force"] + (["--sites"] if shape == "train_4k" else []),
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for shape in DRYRUN_CELLS}
    procs["smoke"] = subprocess.Popen(
        cmd + ["--smoke"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    recs, smoke = {}, None
    try:
        for shape, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            if proc.returncode:
                raise AssertionError(f"[dryrun] {shape} failed:\n{stdout}"
                                     f"\n{stderr[-4000:]}")
            if shape == "smoke":
                smoke = json.loads(stdout.strip().splitlines()[-1])
                print(f"[dryrun] every family's SMOKE train cell on (4, 2), "
                      f"this host's CPU: "
                      f"{time.perf_counter() - t0:.1f} s since all started",
                      flush=True)
                continue
            path = Path(ROOT) / "build" / "dryrun_torch" / \
                f"granite_8b__{shape}__pod.json"
            rec = json.loads(path.read_text())
            missing = [k for k in DRYRUN_KEYS if k not in rec]
            mem, dev = rec.get("memory", {}), rec.get("per_device", {})
            if missing or not (dev.get("hlo_flops", 0) > 0
                               and mem.get("argument_bytes", 0) > 0
                               and dev.get("hlo_bytes", 0) > 0
                               and dev.get("collective_wire_bytes", 0) > 0):
                raise AssertionError(f"[dryrun] {shape}: missing {missing} "
                                     f"or a zero count: {rec}")
            print(f"[dryrun] granite_8b x {shape} x pod (16 x 16, 256 fake "
                  f"ranks, this host's CPU, {time.perf_counter() - t0:.1f} "
                  f"s since both started): per device "
                  f"{dev['hlo_flops']:.6g} FLOPs, "
                  f"{dev['hlo_bytes']:.6g} bytes accessed, "
                  f"{dev['collective_wire_bytes']:.6g} collective wire bytes "
                  f"{ {k: v for k, v in dev['collective_by_kind'].items() if v} }; "
                  f"arguments {mem['argument_bytes']} B, peak "
                  f"{mem['peak_bytes_est']} B; useful FLOPs "
                  f"{rec['useful_flops_ratio']:.4f}; terms "
                  f"{rec['roofline_terms_s']} (H100 SXM data-sheet rates); "
                  f"dominant {rec['dominant']}", flush=True)
            recs[shape] = rec
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return recs, smoke


def _hold_smoke_counts(smoke: dict) -> None:
    """Every family's SMOKE train count on this host's torch within
    ``DRYRUN_SMOKE_REL`` of the torch 2.13 count."""
    off = {}
    for arch, want in DRYRUN_SMOKE_WIRE_213.items():
        got = smoke[arch]
        rel = abs(got - want) / want
        print(f"[dryrun] {arch} SMOKE train (4, 2): {got:.0f} collective "
              f"wire bytes a device on torch {torch.__version__}, "
              f"{want:.0f} on torch 2.13 (relative difference {rel:.2e})",
              flush=True)
        if rel > DRYRUN_SMOKE_REL:
            off[arch] = (got, want)
    if off or set(smoke) != set(DRYRUN_SMOKE_WIRE_213):
        raise AssertionError(f"[dryrun] SMOKE train counts off the torch 2.13 "
                             f"counts by more than {DRYRUN_SMOKE_REL}: {off}; "
                             f"families {sorted(smoke)}")


def _active_blocks() -> dict:
    """{address: (size, requested size)} of the allocator's live blocks."""
    out = {}
    for seg in torch.cuda.memory_snapshot():
        for blk in seg["blocks"]:
            if blk["state"] == "active_allocated":
                out[blk["address"]] = (blk["size"],
                                       blk.get("requested_size", blk["size"]))
    return out


def _grown(before: dict) -> tuple:
    """(requested bytes, allocated bytes) of the blocks made since
    ``before``: the allocator rounds each request up (512-byte blocks, and
    a large block keeps a tail under 1 MB unsplit)."""
    new = [v for a, v in _active_blocks().items() if a not in before]
    return sum(r for _, r in new), sum(s for s, _ in new)


def _allocated_by(make):
    """(``make()``, the bytes its live tensors requested, the bytes of their
    allocator blocks, the growth of ``memory_allocated``)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    before = _active_blocks()
    out = make()
    torch.cuda.synchronize()
    growth = torch.cuda.memory_allocated() - base
    return (out,) + _grown(before) + (growth,)


def _predict(cfg, shape):
    """The dry-run's record pieces for ``cfg`` at ``shape`` on a (1, 1)
    ("data", "model") mesh over a fake group of one rank, on meta state."""
    with dryrun.fake_group(1):
        mesh = torch.distributed.device_mesh.init_device_mesh(
            "cpu", (1, 1), mesh_dim_names=("data", "model"))
        return dryrun.analyze_cell(cfg, shape, mesh)


def _held_on_card(label, pred, make_args, step, card):
    """Hold one predicted cell against the card: the argument bytes against
    what the allocator gained once the arguments exist, the FLOPs against
    FlopCounterMode over the real step, and print peak and step time beside
    the prediction. Returns the step's output and arguments."""
    from torch.utils.flop_counter import FlopCounterMode

    args, requested, allocated, growth = _allocated_by(make_args)
    want = pred["memory"]["argument_bytes"]
    if requested != want or growth != allocated:
        raise AssertionError(
            f"[dryrun] {label}: predicted argument bytes {want}, the card's "
            f"requests {requested}, memory_allocated grew {growth} "
            f"(blocks {allocated})")
    with FlopCounterMode(display=False) as fc:
        step(*args)
    torch.cuda.synchronize()
    flops = fc.get_total_flops()
    if flops != pred["per_device"]["hlo_flops"]:
        raise AssertionError(f"[dryrun] {label}: predicted "
                             f"{pred['per_device']['hlo_flops']:.6g} FLOPs, "
                             f"FlopCounterMode {flops:.6g}")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    dev = pred["per_device"]
    terms = {"compute_s": dev["hlo_flops"] / dryrun.PEAK_FLOPS,
             "memory_s": dev["hlo_bytes"] / dryrun.HBM_BW}
    top = max(terms, key=terms.get)
    print(f"[dryrun] {label} on {card}: argument bytes predicted {want}, "
          f"memory_allocated grew {growth} ({growth - want} of allocator "
          f"rounding); FLOPs predicted {dev['hlo_flops']:.6g} = "
          f"FlopCounterMode {flops:.6g}; temp (peak above the arguments) "
          f"predicted {pred['memory']['temp_bytes']} B, measured {peak} B "
          f"(ratio {pred['memory']['temp_bytes'] / max(peak, 1):.4f}); step "
          f"{ms:.2f} ms against its largest roofline term {top} "
          f"{terms[top] * 1e3:.4f} ms (ratio {ms / (terms[top] * 1e3):.2f}; "
          f"data-sheet rates)", flush=True)
    return out, args


def phase_dryrun(device, card):
    """The dry-run (``repro_torch.launch.dryrun``): (a) granite_8b's train
    and decode cells on the production pod mesh, in a subprocess; (b) its
    prediction for relic_tiny at full width, the 8 x 256 train step and a
    batch-8 decode step, held against the same steps on the card over a
    one-rank NCCL ``(1, 1)`` mesh; (c) the mesh serve step's tokens against
    the plain serve step's, exactly, every attention of the mesh step
    split-T (its cache's time axis sharded over a "model" axis of one)."""
    recs, smoke = _dryrun_records()
    _hold_smoke_counts(smoke)
    wire = {k: r["per_device"]["collective_wire_bytes"]
            for k, r in recs.items()}
    peak = recs["train_4k"]["memory"]["peak_bytes_est"]
    sites = recs["train_4k"]["per_device"]["collective_by_site"]
    top = "; ".join(f"{k} {v:.6g}" for k, v in list(sites.items())[:3])
    print(f"[dryrun] granite_8b collective wire bytes a device on the pod "
          f"mesh: decode_32k {wire['decode_32k']:.6g} (split-T; below "
          f"{DRYRUN_DECODE_WIRE_MAX:.0e}), train_4k {wire['train_4k']:.6g} "
          f"(the reference's depth-exact count {DRYRUN_TRAIN_WIRE_MAX:.6g}), "
          f"its predicted peak {peak / 1e9:.4f} GB (at most "
          f"{DRYRUN_TRAIN_PEAK_MAX / 1e9:.2f}); train_4k's largest sites: "
          f"{top}", flush=True)
    if not wire["decode_32k"] < DRYRUN_DECODE_WIRE_MAX:
        raise AssertionError(f"[dryrun] decode_32k moves "
                             f"{wire['decode_32k']:.6g} collective bytes a "
                             f"device: the cache is gathered")
    if not wire["train_4k"] <= DRYRUN_TRAIN_WIRE_MAX:
        raise AssertionError(f"[dryrun] train_4k moves "
                             f"{wire['train_4k']:.6g} collective bytes a "
                             f"device, above the reference's "
                             f"{DRYRUN_TRAIN_WIRE_MAX:.6g}")
    if not peak <= DRYRUN_TRAIN_PEAK_MAX:
        raise AssertionError(f"[dryrun] train_4k's predicted peak {peak} B "
                             f"is above {DRYRUN_TRAIN_PEAK_MAX:.6g}")

    cfg = get_config(ARCH)
    train = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH)
    decode = dataclasses.replace(SHAPES["decode_32k"],
                                 seq_len=DRYRUN_DECODE_LEN,
                                 global_batch=SERVE_BATCH)
    dcfg = dryrun._prep_cfg(cfg, decode)
    preds = {"train": _predict(cfg, train), "decode": _predict(dcfg, decode)}
    for policy in ("full", "dots"):   # relic_tiny keeps "none" itself
        preds[policy] = _predict(cfg.replace(remat=policy), train)

    init_distributed(device)
    if torch.distributed.get_backend() != "nccl":
        raise AssertionError("the dry-run phase must run over NCCL")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device)
        model = build_model(cfg, device)
        gen = np.random.default_rng(0)

        def batch_for(shape, m):
            specs, _ = m.input_specs(shape)
            return {k: (torch.as_tensor(gen.integers(0, cfg.vocab_size,
                                                     v.shape), device=device)
                        .to(v.dtype) if not v.dtype.is_floating_point
                        else torch.ones(v.shape, dtype=v.dtype, device=device))
                    for k, v in specs.items()}

        def train_args():
            plain = make_train_state(model, torch.Generator().manual_seed(0))
            state = shd.distribute_state(plain, mesh)
            del plain
            return state, shd.shard_batch(batch_for(train, model), mesh)

        _held_on_card(f"{cfg.name} train [{TRAIN_BATCH}, {TRAIN_SEQ}]",
                      preds["train"], train_args,
                      make_train_step(model, OptConfig(), mesh=mesh), card)
        for policy in ("full", "dots"):
            _held_on_card(
                f"{cfg.name} train [{TRAIN_BATCH}, {TRAIN_SEQ}], remat "
                f"{policy!r}", preds[policy], train_args, make_train_step(
                    build_model(cfg.replace(remat=policy), device), OptConfig(),
                    mesh=mesh), card)

        dmodel = build_model(dcfg, device)
        dparams = dmodel.init(torch.Generator().manual_seed(0))
        mesh_step = make_serve_step(dmodel, mesh)

        def decode_args():
            return (shd.distribute_params(dparams, mesh),
                    shd.distribute_cache(dmodel.init_cache(
                        SERVE_BATCH, DRYRUN_DECODE_LEN), mesh),
                    shd.shard_batch(batch_for(decode, dmodel),
                                    mesh)["tokens"],
                    DRYRUN_DECODE_LEN - 1)

        _held_on_card(f"{cfg.name} decode batch {SERVE_BATCH}, cache "
                      f"{DRYRUN_DECODE_LEN}", preds["decode"], decode_args,
                      mesh_step, card)

        # (c) the same greedy tokens from the mesh step and the plain one
        prompt = batch_for(decode, dmodel)["tokens"]
        runs, paths = [], []
        for step, params, cache in (
                (make_serve_step(dmodel), dparams,
                 dmodel.init_cache(SERVE_BATCH, DRYRUN_DECODE_LEN)),
                (mesh_step, shd.distribute_params(dparams, mesh),
                 shd.distribute_cache(dmodel.init_cache(
                     SERVE_BATCH, DRYRUN_DECODE_LEN), mesh))):
            tok, toks = prompt, []
            with _calls((attn, "combine_partials"),
                        (attn, "_per_head_shard")) as calls:
                for pos in range(DRYRUN_TOKENS):
                    tok, _, cache = step(params, cache, tok, pos)
                    tok = (tok.full_tensor() if hasattr(tok, "full_tensor")
                           else tok)
                    toks.append(tok)
            runs.append(torch.cat(toks, 1))
            paths.append(dict(calls))
        same = torch.equal(runs[0], runs[1])
        split = {"combine_partials": DRYRUN_TOKENS * cfg.n_layers,
                 "_per_head_shard": 0}
        print(f"[dryrun] {cfg.name} serve step on the (1, 1) mesh against the "
              f"plain serve step, {DRYRUN_TOKENS} greedy steps of batch "
              f"{SERVE_BATCH}: tokens equal {same}; mesh step's attention "
              f"calls {paths[1]} (plain {paths[0]}); {card}")
        if not same:
            raise AssertionError("[dryrun] the mesh serve step's tokens differ")
        if paths != [{"combine_partials": 0, "_per_head_shard": 0}, split]:
            raise AssertionError(f"[dryrun] the mesh serve step's attention "
                                 f"did not take split-T on every layer: "
                                 f"{paths}, want {split}")
    finally:
        torch.distributed.destroy_process_group()


# granite_8b's decode attention at full width on the pod's cache layout:
# batch 8, a 32k cache of 8 kv heads of 128, 32 query heads, the time axis
# cut 16 ways as the 16 x 16 pod's "model" axis cuts it; and its loss's
# logits (vocab 49152) cut 16 ways.
SPLIT_CACHE = (8, 32768, 8, 128)   # (b, t, kv, d)
SPLIT_HEADS = 32
SPLIT_POS = 30000
SPLIT_SLICES = 16
SPLIT_LOGITS = (8, 192, 49152)
SPLIT_LL_TOL = 1e-5   # tests/test_torch_split_decode.py's f32 bar


def phase_split_decode(device, card):
    """Split-T decode attention and the vocab-parallel log-likelihood at
    granite_8b's full width, each cut on the card as the pod mesh cuts it
    and combined with the default ``reduce`` over the stacked slices (the
    arithmetic of the mesh path, whose all-reduces one card cannot run
    between ranks): held against the unsplit function and timed beside
    it."""
    gen = torch.Generator(device=device).manual_seed(0)
    b, t, kv, d = SPLIT_CACHE
    bf16 = torch.bfloat16

    def rnd(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    q, k, v = rnd(b, 1, SPLIT_HEADS, d), rnd(b, t, kv, d), rnd(b, t, kv, d)
    n, kv_len = SPLIT_SLICES, SPLIT_POS + 1
    tl = t // n

    def split():
        parts = [attn.attention_partial(q, k[:, i * tl:(i + 1) * tl],
                                        v[:, i * tl:(i + 1) * tl], t0=i * tl,
                                        kv_len=kv_len) for i in range(n)]
        o, m, l = (torch.stack(x) for x in zip(*parts))
        return attn.combine_partials(o, m, l).to(q.dtype)

    def full():
        return attn.attention_full(q, k, v, causal=False, kv_len=kv_len)

    with torch.no_grad():
        got, want = split(), full()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got, want, rtol=TOL[bf16], atol=TOL[bf16])
        split_ms, full_ms = kernel_ms(split, n=5), kernel_ms(full, n=5)
        split_ev, full_ev = time_ms(split, 10), time_ms(full, 10)

    def ms(x):
        return "not measured" if x is None else f"{x:.4f} ms"

    # bound: the cache read once, by bytes (the products are 2 x 32 x 128
    # operations a position and row, far below the tensor cores' rate)
    bound = 2 * k.numel() * k.element_size() / PEAK_BYTES_S * 1e3
    print(f"[split] decode attention q [{b}, 1, {SPLIT_HEADS}, {d}] over a "
          f"[{b}, {t}, {kv}, {d}] bf16 cache at position {SPLIT_POS}, T cut "
          f"into {n} slices of {tl}: attention_partial x {n} + "
          f"combine_partials device {ms(split_ms)} (events "
          f"{split_ev:.4f} ms), attention_full {ms(full_ms)} (events "
          f"{full_ev:.4f} ms), bound {bound:.4f} ms by bytes; max |diff| "
          f"{err:.3g} (tol {TOL[bf16]}); {card}", flush=True)
    del q, k, v, got, want

    bs, s, vocab = SPLIT_LOGITS
    x = rnd(bs, s, vocab, dtype=torch.float32) * 4
    labels = torch.randint(0, vocab, (bs, s), generator=gen, device=device)
    w = rnd(bs, s, dtype=torch.float32)
    v0 = (torch.arange(n, device=device) * (vocab // n))[:, None, None]

    def split_ll(xx):
        stacked = xx.reshape(bs, s, n, vocab // n).permute(2, 0, 1, 3)
        return L.combine_vocab_partials(*L.vocab_partial(stacked, labels,
                                                         v0))

    def full_ll(xx):
        logp = torch.log_softmax(xx, dim=-1)
        return torch.gather(logp, -1, labels[..., None])[..., 0]

    grads = []
    for fn in (split_ll, full_ll):
        xx = x.clone().requires_grad_(True)
        ll = fn(xx)
        (ll * w).sum().backward()
        grads.append((ll.detach(), xx.grad))
    (got, g_got), (want, g_want) = grads
    err = (got - want).abs().max().item()
    g_err = (g_got - g_want).abs().max().item()
    torch.testing.assert_close(got, want, rtol=SPLIT_LL_TOL, atol=SPLIT_LL_TOL)
    torch.testing.assert_close(g_got, g_want, rtol=SPLIT_LL_TOL,
                               atol=SPLIT_LL_TOL)
    del grads, g_got, g_want
    with torch.no_grad():
        split_ms, full_ms = (kernel_ms(lambda: split_ll(x), n=5),
                             kernel_ms(lambda: full_ll(x), n=5))
        split_ev, full_ev = (time_ms(lambda: split_ll(x), 10),
                             time_ms(lambda: full_ll(x), 10))
    # bound: the logits read once, by bytes
    bound = x.numel() * x.element_size() / PEAK_BYTES_S * 1e3
    print(f"[split] log-likelihood of [{bs}, {s}, {vocab}] f32 logits, the "
          f"vocab cut into {n} slices of {vocab // n}: vocab_partial + "
          f"combine_vocab_partials device {ms(split_ms)} (events "
          f"{split_ev:.4f} ms), log_softmax + gather {ms(full_ms)} (events "
          f"{full_ev:.4f} ms), bound {bound:.4f} ms by bytes; max |diff| "
          f"{err:.3g}, gradient {g_err:.3g} (tol {SPLIT_LL_TOL}); {card}",
          flush=True)


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


def _on_device(tree, device) -> bool:
    if isinstance(tree, (list, tuple)):
        return all(_on_device(t, device) for t in tree)
    return isinstance(tree, torch.Tensor) and tree.device.type == device.type


def _lane_streams(device):
    """The distinct streams LANE_THREADS live threads take as their lane
    stream (``tasks/streams.py::lane_stream``), as every
    ``thread_per_task`` iteration's new thread does: at most torch's pool of
    32 streams a priority if the lane draws from that pool, one a thread if
    it creates a stream."""
    handles, ready = [], threading.Barrier(LANE_THREADS)

    def lane():
        handles.append(lane_stream(device).cuda_stream)
        ready.wait(timeout=60)

    threads = [threading.Thread(target=lane) for _ in range(LANE_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    if any(t.is_alive() for t in threads) or len(handles) != LANE_THREADS:
        raise AssertionError(f"[strategies] {len(handles)} of {LANE_THREADS} "
                             "lane threads took a stream")
    return len(set(handles))


def phase_strategies(device, card):
    """The paper's strategy comparison on the card (the reference's
    ``benchmarks/run.py`` fig1 and fig4 sections, ported as
    ``repro_torch.tasks.strategies``): the seven PAPER_WORKLOADS kernels,
    two instances each, under all eight strategies, STRATEGY_PASSES passes
    of ``bench_strategies`` (STRATEGY_ITERS timed iterations after
    STRATEGY_WARMUP), every strategy's results on the card and through the
    workload's oracle once a pass before it is timed. Prints the fig1 rows
    (µs per iteration, the median pass, and speedup over serial), the fig4
    geomeans (a kernel a strategy slows counts 1.0) and Relic's gain over
    the best other framework; then runs ``python -m repro_torch.relic_tasks
    --iters RELIC_TASKS_ITERS`` in this process on the card."""
    loads = {name: make_workload(name, device=device)
             for name in PAPER_WORKLOADS}
    passes = {name: [] for name in loads}
    for _ in range(STRATEGY_PASSES):
        for name, w in loads.items():
            def check(res, w=w, name=name):
                if not _on_device(res, device):
                    raise AssertionError(f"[strategies] {name}: a result "
                                         f"off {device.type}")
                w.check(res)
            ta, tb = w.tasks
            da, db = w.dispatches
            passes[name].append(bench_strategies(
                ta, tb, w.fused_task(), dispatch_a=da, dispatch_b=db,
                iters=STRATEGY_ITERS, warmup=STRATEGY_WARMUP, device=device,
                check=check))
    results = {name: {s: float(np.median([r[s] for r in rs]))
                      for s in STRATEGIES} for name, rs in passes.items()}
    print(f"# fig1 on {card}: µs per iteration (two instances; the median "
          f"of {STRATEGY_PASSES} passes of {STRATEGY_ITERS} iterations, "
          "thread_per_task 100) and speedup over serial")
    print("name,us_per_call,derived")
    for kernel, res in results.items():
        for s in STRATEGIES:
            print(f"fig1/{kernel}/{s},{res[s]:.2f},"
                  f"speedup={res['serial'] / res[s]:.3f}")
    geo, gain = fig4_geomeans(results)
    print("# fig4: geomean speedup, negative outliers replaced by serial")
    print("name,us_per_call,derived")
    for s in STRATEGIES:
        mean_us = sum(r[s] for r in results.values()) / len(results)
        print(f"fig4/{s},{mean_us:.2f},geomean_speedup={geo[s]:.3f}")
    print(f"fig4/relic_vs_best_framework,0.00,relic_gain={gain * 100:.1f}%")
    print("[strategies] every pass, µs per iteration: " + json.dumps(
        {k: {s: [round(r[s], 1) for r in rs] for s in STRATEGIES}
         for k, rs in passes.items()}))
    print(f"[strategies] {LANE_THREADS} live threads took "
          f"{_lane_streams(device)} distinct lane streams (torch's pool holds "
          "32 a priority)")

    t0 = time.perf_counter()
    res = relic_tasks.main(["--iters", str(RELIC_TASKS_ITERS)])
    if tuple(res) != PAPER_WORKLOADS or any(tuple(r) != STRATEGIES
                                            for r in res.values()):
        raise AssertionError(f"[strategies] relic_tasks timed {res}")
    print(f"[strategies] relic_tasks --iters {RELIC_TASKS_ITERS} on "
          f"{device.type}: {time.perf_counter() - t0:.1f} s", flush=True)


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


# ---------------------------------------------------------------------------
# The other families: dense (granite, phi3), encoder-decoder (whisper), MoE
# (arctic) and the VLM (paligemma: its prefix path and its text forward)
# ---------------------------------------------------------------------------

def _dense_path(arch, launches, device, entries, n_layers=None):
    """A dense family at full width (and depth, unless ``n_layers`` cuts
    it): served through ``serve.main``, then its teacher-forced forward
    [8, 192] through ``launches`` launches of the wgmma flash design and as
    many of the RoPE kernel (one a layer), held at the dense family's bf16
    bars against the plain forward and the served tokens."""
    _reset_launches()
    gen_toks, (cfg, model, params), served = serve_main(arch, GEN, device,
                                                        n_layers)
    want = {"flash_attention": launches, "rope": launches}
    tokens, logits_k, logits_p = phase_forward(cfg, params, gen_toks, want,
                                               True, device)
    _count_path(arch, want, entries)
    del logits_k, logits_p
    return {**served, "outside_ms_per_step": decode_outside(cfg, model, params,
                                                            device),
            **time_forwards(cfg, params, tokens)}


def phase_granite(device, entries):
    """granite_8b (32 heads of 128 over 8 kv heads) at full width, its 36
    layers cut to GRANITE_LAYERS: one wgmma launch a layer at head_dim
    128."""
    return _dense_path(GRANITE, GRANITE_LAUNCHES, device, entries,
                       GRANITE_LAYERS)


def phase_phi3(device, entries):
    """phi3_mini_3p8b (32 layers, d_model 3072, 32 heads of 96 over 32 kv
    heads, d_ff 8192, vocab 32064): 32 wgmma launches at head_dim 96."""
    return _dense_path(PHI3, PHI3_LAUNCHES, device, entries)


@torch.no_grad()
def phase_zamba2_7b(device, entries):
    """Zamba2-7B-Instruct at its published width and depth (81 Mamba-2
    layers, 2 shared blocks used at 13 of them; 7.357 B parameters drawn as
    the benchmark draws them, ``portbench/configs/zamba2_7b.json``, served
    in bf16 with the kernels): one forward over ``ZAMBA2_7B_TOKENS`` from
    launch counts of 0, exactly 81 ssd launches through the tensor-core
    design, 81 conv launches, 13 flash launches through the wgmma design
    (head_dim 224) and 13 RoPE launches, with finite logits; then the
    forward timed."""
    from portbench.harness import program
    from portbench.reference import zamba2 as z2_ref

    doc = json.loads((Path(ROOT) / "portbench" / "configs"
                      / f"{ZAMBA2_7B}.json").read_text())
    m = {**doc["model"], **doc["serve"]}
    t0 = time.perf_counter()
    model, params, flat, _ = program.build(m, z2_ref, 2**31 + 7, device, False,
                                           doc["init_rules"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    b, s = ZAMBA2_7B_TOKENS
    tokens = torch.randint(0, m["vocab_size"], (b, s), device=device,
                           generator=torch.Generator(device=device).manual_seed(2))
    _reset_launches()
    logits, _ = model.forward(params, tokens)
    torch.cuda.synchronize()
    _count_path(ZAMBA2_7B, ZAMBA2_7B_LAUNCHES, entries)
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{ZAMBA2_7B}: non-finite logits")
    del logits
    t0 = time.perf_counter()
    model.forward(params, tokens)
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t0) * 1e3
    n_params = flat.numel()
    print(f"[forward] {ZAMBA2_7B} tokens {[b, s]} bf16: {n_params} "
          f"parameters drawn in {init_s:.1f} s, forward {forward_ms:.1f} ms")
    del model, params, flat
    return {"params": n_params, "forward_ms": forward_ms}


def _ce(logits, tokens):
    """Teacher-forced next-token cross-entropy: position i predicts i + 1."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return -torch.gather(logp, -1, tokens[:, 1:, None])[..., 0].mean()


@torch.no_grad()
def phase_whisper(device, entries):
    """whisper_large_v3 at full width and depth: served through
    ``serve.main`` (frames -> encode -> cross cache -> prefill -> decode),
    then the teacher-forced forward over the served frames and 192 decoder
    tokens: 96 flash launches, all through the wgmma design, held at the
    bf16 bars; then the loss forward (``encdec_loss``) with the kernels,
    96 launches again, against the plain one."""
    _reset_launches()
    gen_toks, (cfg, model, params), served = serve_main(WHISPER, GEN, device)
    frames = serve.make_frames(cfg, SERVE_BATCH, PROMPT_LEN, device)
    tokens, logits_k, logits_p = phase_forward(
        cfg, params, gen_toks, {"flash_attention": WHISPER_LAUNCHES}, True,
        device, extra=frames)
    _count_path(WHISPER, {"flash_attention": WHISPER_LAUNCHES}, entries)
    ce_k, ce_p = _ce(logits_k, tokens).item(), _ce(logits_p, tokens).item()
    del logits_k, logits_p

    batch = {"frames": frames, "tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "mask": torch.ones(tokens[:, 1:].shape, device=device)}
    loss_k, _ = _launched("wgmma_launches", WHISPER_LAUNCHES, lambda: _launched(
        "launches", WHISPER_LAUNCHES, lambda: encdec_loss(
            cfg.replace(use_kernels=True), params, batch), "encdec_loss"),
        "encdec_loss with the kernels")
    loss_p, _ = encdec_loss(cfg, params, batch)
    loss_k, loss_p = loss_k.item(), loss_p.item()
    print(f"[forward] {cfg.name}: loss forward [{SERVE_BATCH}, {TEXT_LEN - 1}] "
          f"decoder tokens over {cfg.frontend.n_tokens} frames: with kernels "
          f"{loss_k:.5f} ({WHISPER_LAUNCHES} wgmma launches), plain "
          f"{loss_p:.5f}; the forward's own next-token loss {ce_k:.5f} / "
          f"{ce_p:.5f}")
    if not (np.isfinite(loss_k) and abs(loss_k - loss_p) <= MODEL_TOL):
        raise AssertionError(f"{cfg.name}: loss {loss_k} against {loss_p}")
    return {**served, "outside_ms_per_step": decode_outside(cfg, model, params,
                                                            device),
            **time_forwards(cfg, params, tokens, frames)}


def _check_init(cfg, params):
    """Every leaf's shape and scale against the reference's ``init_*``
    (models/moe.py:31-45, layers.py, attention.py): norms at 1 / 0, every
    other leaf a normal of its fan-in's scale (the embedding and the
    unembedding of their own); each expert of a stack on its own."""
    d, f = cfg.d_model, cfg.moe.d_ff
    hd, h, kv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    want = {"embed.table": ((cfg.vocab_size, d), 0.02),
            "lm_head.kernel": ((d, cfg.vocab_size), d ** -0.5),
            "final_norm.scale": ((d,), 1.0)}
    for i in range(cfg.n_layers):
        want.update({
            f"layers.{i}.ln1.scale": ((d,), 1.0),
            f"layers.{i}.ln2.scale": ((d,), 1.0),
            f"layers.{i}.attn.wq": ((d, h, hd), d ** -0.5),
            f"layers.{i}.attn.wk": ((d, kv, hd), d ** -0.5),
            f"layers.{i}.attn.wv": ((d, kv, hd), d ** -0.5),
            f"layers.{i}.attn.wo": ((h, hd, d), (h * hd) ** -0.5),
            f"layers.{i}.moe.router": ((d, cfg.moe.n_experts), d ** -0.5),
            f"layers.{i}.moe.w_gate": ((cfg.moe.n_experts, d, f), d ** -0.5),
            f"layers.{i}.moe.w_up": ((cfg.moe.n_experts, d, f), d ** -0.5),
            f"layers.{i}.moe.w_down": ((cfg.moe.n_experts, f, d), f ** -0.5),
            f"layers.{i}.moe.shared.w_gate": ((d, cfg.d_ff), d ** -0.5),
            f"layers.{i}.moe.shared.w_up": ((d, cfg.d_ff), d ** -0.5),
            f"layers.{i}.moe.shared.w_down": ((cfg.d_ff, d), cfg.d_ff ** -0.5)})
    got = dict(params.named_parameters())
    if set(got) != set(want):
        raise AssertionError(f"arctic parameters: missing "
                             f"{sorted(set(want) - set(got))}, unexpected "
                             f"{sorted(set(got) - set(want))}")
    worst = 0.0
    for name, (shape, scale) in want.items():
        t = got[name]
        if tuple(t.shape) != shape or t.dtype != torch.bfloat16:
            raise AssertionError(f"{name}: {tuple(t.shape)} {t.dtype}, want {shape}")
        if name.endswith("scale"):
            if not bool((t == 1).all()):
                raise AssertionError(f"{name}: not all ones")
            continue
        stack = t if name.split(".")[-1].startswith("w_") and t.dim() == 3 else t[None]
        # five standard errors of a sample std (1 / sqrt(2n)), plus 1%
        tol = 0.01 + 5 / (2 * stack[0].numel()) ** 0.5
        for e in range(stack.shape[0]):
            std = stack[e].float().std().item()
            worst = max(worst, abs(std / scale - 1))
            if not abs(std / scale - 1) < tol:
                raise AssertionError(f"{name}[{e}]: std {std}, want {scale} "
                                     f"within {tol:.2%}")
    print(f"[arctic] init: {len(want)} leaves in the reference's shapes, every "
          f"norm at 1, every normal (each expert on its own) within "
          f"{worst:.2%} of its scale (tol 1% plus five standard errors)")


def _check_routes(cfg, routes):
    """The routing tables of the forward's MoE calls, well formed at full
    width: experts in range and distinct per token, gates in (0, 1] and
    descending, every kept (expert, slot) once per row and below the
    capacity, keep exactly slot < capacity, aux finite and positive."""
    mc = cfg.moe
    for logits, cap, (eidx, probs, slot, keep, aux) in routes:
        b, s, k = eidx.shape
        if not (eidx.min() >= 0 and eidx.max() < mc.n_experts
                and (eidx[..., :1] != eidx[..., 1:]).all()):
            raise AssertionError("expert indices out of range or repeated")
        if not ((probs > 0).all() and (probs <= 1).all()
                and (probs[..., :-1] >= probs[..., 1:]).all()):
            raise AssertionError("gates not in (0, 1] or not descending")
        if not torch.equal(keep, slot < cap) or not (slot >= 0).all():
            raise AssertionError("keep is not slot < capacity")
        ids = (torch.arange(b, device=eidx.device)[:, None, None] * mc.n_experts
               + eidx) * (s * k) + slot
        kept = ids[keep]
        if kept.numel() != kept.unique().numel():
            raise AssertionError("a kept (expert, slot) taken twice in a row")
        if not (torch.isfinite(aux) and aux > 0):
            raise AssertionError(f"aux {aux}")
        print(f"[arctic] routes [{b}, {s}] x top-{k} over {mc.n_experts} "
              f"experts, capacity {cap}: {int(keep.sum())} of {keep.numel()} "
              f"choices kept, {int((slot == 0).sum())} (row, expert) buffers "
              f"used, aux {aux.item():.5f}")


@torch.no_grad()
def phase_arctic(device, entries):
    """arctic_480b at full width, its depth cut to ARCTIC_LAYERS: the init
    held against the reference's shapes and scales (the expert stacks drawn
    one expert at a time from the host generator into the bf16 tensor on
    the card), the forward [8, 192] through one flash launch (head_dim 128,
    the wgmma design) held at the bf16 bars against the plain one with
    its routing tables checked, then ARCTIC_DECODE decode steps against the
    teacher-forced forward in the drop-free regime (capacity_factor
    n_experts / top_k: every expert can take every token), as
    tests/test_models.py:88-123 holds the MoE."""
    _reset_launches()
    cfg = get_config(ARCTIC).replace(n_layers=ARCTIC_LAYERS,
                                     param_dtype="bfloat16")
    model = build_model(cfg, device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[arctic] {cfg.name} at full width, depth cut to {cfg.n_layers} "
          f"layer(s): {n_params / 1e9:.3f} B parameters, {n_params * 2 / 1e9:.2f} "
          f"GB in bf16; init {init_s:.1f} s")
    _check_init(cfg, params)

    tokens = serve.make_prompts(cfg, SERVE_BATCH, TEXT_LEN, device)
    route, routes = moe.route, []

    def capture(mc, logits, cap):
        out = route(mc, logits, cap)
        routes.append((logits, cap, out))
        return out

    cfg_k = cfg.replace(use_kernels=True)
    moe.route = capture
    try:
        logits_k, aux_k = _launched("launches", cfg.n_layers, lambda: lm_forward(
            cfg_k, params, tokens), f"{cfg.name} forward")
    finally:
        moe.route = route
    logits_p, aux_p = lm_forward(cfg, params, tokens)
    if not (torch.isfinite(logits_k).all() and torch.isfinite(logits_p).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    err = (logits_k - logits_p).abs().max().item()
    agree = _agree(logits_k, logits_p)
    print(f"[forward] {cfg.name} tokens {list(tokens.shape)} bf16: max|logits "
          f"kernel - plain| {err:.3g}, relative {_rel(logits_k, logits_p):.3g}, "
          f"greedy agreement {agree:.4f}; aux {aux_k.item():.6f} / "
          f"{aux_p.item():.6f}")
    torch.testing.assert_close(logits_k, logits_p, rtol=MODEL_TOL, atol=MODEL_TOL)
    if not agree > 0.9:
        raise AssertionError(f"{cfg.name}: greedy agreement {agree} <= 0.9")
    _check_routes(cfg, routes)
    del logits_k, logits_p, routes

    free = cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    fmodel, toks = build_model(free, device), tokens[:, :ARCTIC_DECODE]
    cache, got = fmodel.init_cache(SERVE_BATCH, ARCTIC_DECODE), []
    t0 = time.perf_counter()
    for t in range(ARCTIC_DECODE):
        logits, cache = fmodel.decode_step(params, cache, toks[:, t:t + 1], t)
        got.append(logits[:, 0])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / ARCTIC_DECODE * 1e3
    got = torch.stack(got, dim=1)
    forced, _ = lm_forward(free, params, toks)
    agree = _agree(got, forced)
    print(f"[arctic] {ARCTIC_DECODE} decode steps, batch {SERVE_BATCH}, "
          f"{step_ms:.2f} ms/step: max|decode - teacher-forced| "
          f"{(got - forced).abs().max().item():.3g}, greedy agreement "
          f"{agree:.4f}")
    torch.testing.assert_close(got, forced, rtol=MODEL_TOL, atol=MODEL_TOL)
    if not agree > 0.9:
        raise AssertionError(f"{cfg.name}: decode agreement {agree} <= 0.9")
    _count_path(ARCTIC, {"flash_attention": cfg.n_layers, "rope": cfg.n_layers},
                entries)
    return {"init_s": init_s, "decode_ms_per_step": step_ms,
            **time_forwards(cfg, params, tokens)}


@torch.no_grad()
def phase_paligemma(device, entries):
    """paligemma_3b at full width and depth: text served through
    ``serve.main``, then the loss forward over 256 image patches and 192
    text tokens with and without the kernels: the prefix-LM mask keeps
    every attention off the flash kernel, so no flash launch, one RoPE
    launch a layer (bit for bit apply_rope's) and the same loss both ways
    (1e-6 relative: the same operations), finite. Then the text forward
    over the 192 tokens without patches (no prefix), through 18 launches of
    the wgmma flash design at head_dim 256 (8 heads over one kv head) and
    18 of the RoPE kernel, held at the dense family's bf16 bars against the plain forward
    and the served tokens."""
    _reset_launches()
    gen_toks, (cfg, model, params), served = serve_main(PALIGEMMA, GEN, device)
    prompts = serve.make_prompts(cfg, SERVE_BATCH, PROMPT_LEN, device)
    tokens = torch.cat([prompts, gen_toks], dim=1)
    n_img = cfg.frontend.n_tokens
    patches = torch.as_tensor(np.random.default_rng(2).normal(
        size=(SERVE_BATCH, n_img, cfg.frontend.embed_dim)),
        dtype=torch.float32).to(device=device, dtype=torch.bfloat16)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, dims=1),
             "mask": torch.ones(tokens.shape, device=device), "patches": patches}
    batch["mask"][:, -1] = 0
    rope_before = rope_k.launches
    loss_k, m_k = _launched("launches", 0, lambda: lm_loss(
        cfg.replace(use_kernels=True), params, batch), f"{cfg.name} prefix loss")
    if rope_k.launches - rope_before != cfg.n_layers:
        raise AssertionError(f"{cfg.name} prefix loss: "
                             f"{rope_k.launches - rope_before} RoPE launches, "
                             f"want {cfg.n_layers}")
    loss_p, _ = lm_loss(cfg, params, batch)
    print(f"[forward] {cfg.name}: loss forward over {n_img} patches + "
          f"{TEXT_LEN} text tokens, batch {SERVE_BATCH}: with kernels "
          f"{loss_k.item():.5f}, plain {loss_p.item():.5f} (over "
          f"{int(m_k['tokens'].item())} text positions)")
    if not (torch.isfinite(loss_k)
            and abs(loss_k.item() - loss_p.item()) <= 1e-6 * abs(loss_p.item())):
        raise AssertionError(f"{cfg.name}: loss {loss_k.item()} / {loss_p.item()}")
    text = {"flash_attention": PALIGEMMA_TEXT_LAUNCHES,
            "rope": PALIGEMMA_TEXT_LAUNCHES}
    _, logits_k, logits_p = phase_forward(cfg, params, gen_toks, text, True,
                                          device)
    _count_path(PALIGEMMA, {**text, "rope": 2 * cfg.n_layers}, entries)
    del logits_k, logits_p
    prefix = time_forwards(cfg, params, tokens, patches)
    text_ms = time_forwards(cfg, params, tokens)
    return {**served, "outside_ms_per_step": decode_outside(cfg, model, params,
                                                            device),
            **prefix, "text_forward_ms": text_ms["forward_ms"],
            "plain_text_forward_ms": text_ms["plain_forward_ms"]}


def _remat_batch(cfg, batch, seed, device):
    """Whisper's training batch: ``batch`` rows of 1500 seeded normal frames
    [batch, 1500, 1280] (bf16, the compute dtype) beside REMAT_TEXT decoder
    tokens and their next tokens, all from one seeded numpy generator."""
    rng = np.random.default_rng(seed)
    frames = torch.as_tensor(rng.normal(size=(
        batch, cfg.frontend.n_tokens, cfg.d_model)), dtype=torch.float32)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (batch, REMAT_TEXT + 1)), device=device)
    return {"frames": frames.to(device=device, dtype=torch.bfloat16),
            "tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": torch.ones((batch, REMAT_TEXT), device=device)}


def _first_step_state(state, host):
    """``state`` put back to its first step in place: the parameters copied
    from ``host``, zero moments, step 0."""
    for name, p in state["params"].named_parameters():
        p.data.copy_(host[name])
    for moments in state["opt"].values():
        for t in moments.values():
            t.zero_()
    state["step"] = 0
    return state


def _remat_step(cfg, policy, state, batch, device, timed=1):
    """One train step of ``cfg`` under ``policy`` from ``state``: (metrics,
    the bytes the loss forward leaves allocated, the allocator's peak over
    the step, ms of ``timed`` more steps after it, state). The first is
    what autograd holds for the backward (saved tensors, the dots policy's
    cache, the loss), from a forward of its own whose graph is dropped."""
    model = build_model(cfg.replace(remat=policy), device)
    step = make_train_step(model, TRAIN_OC)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with torch.enable_grad():
        loss, metrics = model.loss(state["params"], batch)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    del loss, metrics
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = step(state, batch)
    metrics = {k: float(v) for k, v in metrics.items()}
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = None
    if timed:
        t0 = time.perf_counter()
        for _ in range(timed):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / timed
    return metrics, held, peak, ms, state


def phase_train_remat(device, card):
    """Rematerialisation (``cfg.remat``; the reference's ``_remat`` wraps
    every block in ``jax.checkpoint``): (a) whisper_large_v3 at full width
    and depth (f32 parameters, bf16 compute, AdamW), one step of batch 2
    from the same state under "none", "dots" and "full": the losses equal
    (1e-6 relative), the grad norms within 1e-3, the bytes the forward
    holds for the backward full < dots < none, the step's peak under "full"
    and "dots" below "none" (the optimizer's phase, the same under each
    policy, sets theirs); (b) REMAT_STEPS steps of batch 8 under its own "full",
    every loss finite and the last below the first (batch 8 under "none"
    is reckoned, not run: it does not fit the card); (c) relic_tiny's 8 x
    256 step under "full" and "dots" beside "none", the losses equal. No
    fallback: a failed checkpoint or an out-of-memory ends the run."""
    cfg = get_config(WHISPER)
    if cfg.remat != "full":
        raise AssertionError(f"{cfg.name} trains under remat {cfg.remat!r}")
    t0 = time.perf_counter()
    state = make_train_state(build_model(cfg, device),
                             torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    host = {n: p.detach().to("cpu", copy=True)
            for n, p in state["params"].named_parameters()}
    n_params = sum(t.numel() for t in host.values())
    static = torch.cuda.memory_allocated()
    print(f"[remat] {cfg.name}: {n_params / 1e9:.4f} B parameters (f32), "
          f"{cfg.enc_layers} + {cfg.n_layers} layers, d_model {cfg.d_model}; "
          f"state drawn in {init_s:.1f} s, {static / 1e9:.2f} GB with the "
          f"moments; {card}", flush=True)

    # (a) batch 2 from the same state under each policy
    batch = _remat_batch(cfg, REMAT_CMP_BATCH, 0, device)
    got = {}
    for policy in REMAT_POLICIES:
        m, held, peak, ms, state = _remat_step(cfg, policy, _first_step_state(
            state, host), batch, device)
        got[policy] = (m, held, peak, ms)
        print(f"[remat] {cfg.name} batch {REMAT_CMP_BATCH} x ({cfg.frontend.n_tokens} "
              f"frames, {REMAT_TEXT} tokens), remat {policy!r}: loss "
              f"{m['loss']:.7f}, grad_norm {m['grad_norm']:.7g}; the forward "
              f"holds {held / 1e9:.3f} GB for the backward; step peak "
              f"{peak / 1e9:.3f} GB ({(peak - static) / 1e9:.3f} above the "
              f"state), {ms:.2f} ms/step (the second step)", flush=True)
    base = got["none"][0]
    for policy in ("dots", "full"):
        m = got[policy][0]
        dl = abs(m["loss"] - base["loss"]) / abs(base["loss"])
        dg = abs(m["grad_norm"] - base["grad_norm"]) / base["grad_norm"]
        if not (dl <= 1e-6 and dg <= 1e-3):
            raise AssertionError(f"[remat] {policy}: loss {dl:.3g}, grad_norm "
                                 f"{dg:.3g} relative from 'none'")
    # What remat changes is what the forward leaves for the backward. The
    # step's peak is the larger of that phase and the optimizer's (the
    # gradients and their clipped copy beside the state, the same under
    # every policy), which sets it under "full" and "dots" alike.
    helds = {k: v[1] for k, v in got.items()}
    peaks = {k: v[2] for k, v in got.items()}
    if not helds["full"] < helds["dots"] < helds["none"]:
        raise AssertionError(f"[remat] held {helds}: not full < dots < none")
    if not max(peaks["full"], peaks["dots"]) < peaks["none"]:
        raise AssertionError(f"[remat] peaks {peaks}: not full, dots < none")

    # (b) batch 8 under "full" for REMAT_STEPS steps
    batch = _remat_batch(cfg, REMAT_BATCH, 1, device)
    step = make_train_step(build_model(cfg, device), TRAIN_OC)
    state = _first_step_state(state, host)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = step(state, batch)
    losses = [metrics["loss"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REMAT_STEPS - 1):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    whisper_ms = (time.perf_counter() - t0) * 1e3 / (REMAT_STEPS - 1)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    act_none = (peaks["none"] - static) * REMAT_BATCH / REMAT_CMP_BATCH
    print(f"[remat] {cfg.name} batch {REMAT_BATCH} x ({cfg.frontend.n_tokens} "
          f"frames, {REMAT_TEXT} tokens), remat 'full': {whisper_ms:.2f} ms/step "
          f"over steps 2-{REMAT_STEPS}, "
          f"{REMAT_BATCH * REMAT_TEXT / whisper_ms * 1e3:.0f} decoder tokens/s "
          f"({REMAT_BATCH * cfg.frontend.n_tokens / whisper_ms * 1e3:.0f}"
          f" frames/s), peak {peak / 1e9:.3f} GB ({(peak - static) / 1e9:.3f} "
          f"above the state); remat 'none' at this batch reckoned, not run: "
          f"{(static + act_none) / 1e9:.1f} GB (the state plus "
          f"{REMAT_BATCH // REMAT_CMP_BATCH} x batch 2's "
          f"{(peaks['none'] - static) / 1e9:.2f} GB above it); {card}",
          flush=True)
    print(f"[remat] losses {' '.join(f'{x:.4f}' for x in losses)}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[remat] non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[remat] loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    device_profile(lambda: step(state, batch), f"{cfg.name} train step, batch "
                   f"{REMAT_BATCH} x ({cfg.frontend.n_tokens} frames, "
                   f"{REMAT_TEXT} tokens), remat 'full'")
    del state, host, step, batch
    torch.cuda.empty_cache()

    # (c) relic_tiny at full width under each policy
    rcfg = get_config(ARCH)
    batch = _train_batch(rcfg, TRAIN_BATCH, TRAIN_SEQ, 0, device)
    small, small_held = {}, {}
    for policy in ("none", "full", "dots"):
        state = make_train_state(build_model(rcfg, device),
                                 torch.Generator().manual_seed(0))
        m, held, peak, ms, state = _remat_step(rcfg, policy, state, batch,
                                               device)
        small[policy], small_held[policy] = m["loss"], held
        print(f"[remat] {rcfg.name} batch [{TRAIN_BATCH}, {TRAIN_SEQ}], remat "
              f"{policy!r}: loss {m['loss']:.7f}, grad_norm "
              f"{m['grad_norm']:.7g}; the forward holds {held / 1e9:.3f} GB; "
              f"step peak {peak / 1e9:.3f} GB, {ms:.2f} ms/step (the second "
              f"step)", flush=True)
        del state
    for policy in ("full", "dots"):
        if abs(small[policy] - small["none"]) > 1e-6 * abs(small["none"]):
            raise AssertionError(f"[remat] {rcfg.name} {policy}: loss "
                                 f"{small[policy]} against {small['none']}")
    if not small_held["full"] < small_held["dots"] < small_held["none"]:
        raise AssertionError(f"[remat] {rcfg.name} held {small_held}")
    torch.cuda.empty_cache()
    return {"whisper_ms_per_step": whisper_ms, "peaks": peaks, "held": helds}


def phase_train_optim(device):
    """relic_tiny at full width (f32 parameters, bf16 compute): OPTIM_STEPS
    steps with ``compress_grads=True`` beside the same steps without, from
    the same weights on one batch: every loss finite and the last below the
    first, the compression residual finite and nonzero; then one Adafactor
    step: the parameters move, stay finite, and the loss falls."""
    cfg = get_config(ARCH)
    model = build_model(cfg, device)
    batch = _train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 0, device)
    runs = {}
    for compress in (False, True):
        oc = dataclasses.replace(TRAIN_OC, compress_grads=compress)
        state = make_train_state(model, torch.Generator().manual_seed(0), oc)
        step, losses = make_train_step(model, oc), []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OPTIM_STEPS):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        ms = (time.perf_counter() - t0) * 1e3 / OPTIM_STEPS
        runs[compress] = (losses, ms)
        print(f"[train] {cfg.name} {'with' if compress else 'without'} "
              f"gradient compression: {ms:.2f} ms/step over {OPTIM_STEPS} "
              f"steps (the first included), losses "
              f"{' '.join(f'{x:.4f}' for x in losses)}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"compress_grads={compress}: losses {losses}")
        if compress:
            res = state["opt"]["residual"].values()
            if not all(torch.isfinite(r).all() for r in res):
                raise AssertionError("non-finite compression residual")
            peak = max(float(r.abs().max()) for r in res)
            print(f"[train] compression residual after {OPTIM_STEPS} steps: "
                  f"max |r| {peak:.3g}, every entry finite")
            if not peak > 0:
                raise AssertionError("the compression residual stayed zero")
        del state

    params = model.init(torch.Generator().manual_seed(0))
    opt = init_adafactor_state(params)
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    t0 = time.perf_counter()
    loss, _ = model.loss(params, batch)
    loss.backward()
    grads, _ = clip_by_global_norm({n: p.grad for n, p in params.named_parameters()},
                                   TRAIN_OC.clip_norm)
    adafactor_update(AdafactorConfig(), grads, opt, params, 0,
                     schedule(dataclasses.replace(TRAIN_OC, peak_lr=1e-2), 0))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        after, _ = model.loss(params, batch)
    moved = max((p.detach() - before[n]).abs().max().item()
                for n, p in params.named_parameters())
    print(f"[train] one Adafactor step (factored second moments, lr "
          f"{schedule(dataclasses.replace(TRAIN_OC, peak_lr=1e-2), 0):.3g}): "
          f"{ms:.2f} ms with its backward, loss {loss.item():.4f} -> "
          f"{after.item():.4f}, largest move {moved:.3g}")
    if not (all(torch.isfinite(p).all() for p in params.parameters())
            and moved > 0 and after.item() < loss.item()):
        raise AssertionError("the Adafactor step did not train")


EXAMPLE_TRAIN_STEPS = 20


def phase_examples(device, card):
    """The port's two device examples as a user runs them, on the card:
    ``repro_torch.serve_batch`` (qwen3_14b at SMOKE size, its defaults) and
    ``repro_torch.train_lm`` (``--steps 20``, its defaults otherwise:
    relic_tiny at SMOKE size, batch 8 x 128, a checkpoint at the end).
    The served tokens and every train step's parameters and batch must lie
    on ``device``; the loss must be finite."""
    t0 = time.perf_counter()
    toks = serve_batch.main(["--arch", "qwen3_14b", "--device", device.type])
    if toks.device.type != device.type or tuple(toks.shape) != (4, 24):
        raise AssertionError(f"[examples] serve_batch gave {tuple(toks.shape)} "
                             f"tokens on {toks.device}")
    t1 = time.perf_counter()
    seen, plain = [], train.make_train_step

    def watched(*args, **kwargs):
        step = plain(*args, **kwargs)

        def run(state, batch):
            seen.append({next(state["params"].parameters()).device.type}
                        | {v.device.type for v in batch.values()})
            return step(state, batch)
        return run

    ckpt = os.path.join(ROOT, "build", "chip_smoke_train_lm")
    shutil.rmtree(ckpt, ignore_errors=True)
    train.make_train_step = watched
    try:
        loss = train_lm.main(["--steps", str(EXAMPLE_TRAIN_STEPS), "--ckpt",
                              ckpt, "--device", device.type])
    finally:
        train.make_train_step = plain
        shutil.rmtree(ckpt, ignore_errors=True)
    if len(seen) != EXAMPLE_TRAIN_STEPS or any(d != {device.type}
                                               for d in seen):
        raise AssertionError(f"[examples] train_lm's steps ran on {seen}")
    if not np.isfinite(loss):
        raise AssertionError(f"[examples] train_lm's final loss {loss}")
    print(f"[examples] on {card}: serve_batch (qwen3_14b, SMOKE) "
          f"{tuple(toks.shape)} tokens on {toks.device}, "
          f"{(t1 - t0):.1f} s; train_lm {EXAMPLE_TRAIN_STEPS} steps, every "
          f"step's parameters and batch on {device.type}, final loss "
          f"{loss:.4f}, {time.perf_counter() - t1:.1f} s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.perf_counter()
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
    entries["ssd"]["grouped"] = phase_ssd_grouped(device)
    phase_wkv6_layout(device)
    entries["rope"] = phase_rope(device)
    entries["conv"] = phase_conv(device)
    print(f"[main] build and kernel phases {time.perf_counter() - t_start:.1f} s")
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

    # The other families, each from launch counts of 0 (each phase resets
    # them and counts its own path).
    flash_at = {}   # each path's first timed flash shape (phase_kernel)
    for o in entries["flash_attention"]["other_shapes"]:
        if o.get("path"):
            flash_at.setdefault(o["path"], o)

    def ms(x):
        return "not measured" if x is None else f"{x:.4f} ms"

    for arch, phase in ((GRANITE, phase_granite), (PHI3, phase_phi3),
                        (WHISPER, phase_whisper), (ARCTIC, phase_arctic),
                        (PALIGEMMA, phase_paligemma),
                        (ZAMBA2_7B, phase_zamba2_7b)):
        t0 = time.perf_counter()
        summary = phase(device, entries)
        torch.cuda.empty_cache()
        fl = flash_at.get(arch)
        print(f"[path] {arch} on {card}: "
              + ", ".join(f"{k} {v:.2f}" for k, v in summary.items())
              + (f"; flash {fl['shape']} device {ms(fl['device_ms'])}, bound "
                 f"{ms(fl['bound_ms'])} by {fl['bound_by']}, sdpa device "
                 f"{ms(fl.get('library_device_ms', fl['library_ms']))}"
                 if fl else "")
              + f"; phase {time.perf_counter() - t0:.1f} s")

    # The quickstart path, from launch counts of 0.
    _reset_launches()
    phase_quickstart(device)
    _count_path("quickstart", QUICKSTART_LAUNCHES, entries)

    # Training runs the plain paths: no kernel launch.
    _reset_launches()
    bare_ms = phase_train(device)
    phase_train_optim(device)
    phase_card_vs_cpu(device)
    torch.cuda.empty_cache()
    t_remat = time.perf_counter()
    phase_train_remat(device, card)
    print(f"[main] remat phase {time.perf_counter() - t_remat:.1f} s")
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
    t_mesh = time.perf_counter()
    phase_mesh(device, card)
    _count_path("mesh", {}, entries)
    print(f"[main] mesh phase {time.perf_counter() - t_mesh:.1f} s")
    torch.cuda.empty_cache()
    _reset_launches()
    t_dry = time.perf_counter()
    phase_dryrun(device, card)
    _count_path("dry-run", {}, entries)
    print(f"[main] dry-run phase {time.perf_counter() - t_dry:.1f} s")
    torch.cuda.empty_cache()
    _reset_launches()
    t_split = time.perf_counter()
    phase_split_decode(device, card)
    _count_path("split decode", {}, entries)
    print(f"[main] split decode phase {time.perf_counter() - t_split:.1f} s")
    torch.cuda.empty_cache()
    _reset_launches()
    t1 = time.perf_counter()
    phase_workloads(device, card)
    _count_path("workloads", {}, entries)
    print(f"[main] train driver {t1 - t0:.1f} s, workloads "
          f"{time.perf_counter() - t1:.1f} s")
    torch.cuda.empty_cache()
    _reset_launches()
    t_strat = time.perf_counter()
    phase_strategies(device, card)
    _count_path("strategies", {}, entries)
    print(f"[main] strategies phase {time.perf_counter() - t_strat:.1f} s")
    torch.cuda.empty_cache()
    _reset_launches()
    t_ex = time.perf_counter()
    phase_examples(device, card)
    _count_path("examples", {}, entries)
    print(f"[main] examples phase {time.perf_counter() - t_ex:.1f} s")

    phase_long(*relic, device)
    print(f"[main] every phase {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": list(entries.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
