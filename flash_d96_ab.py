#!/usr/bin/env python3
"""O += P V at n96 against n128 in flash attention's head_dim-96 instance,
on one CUDA card.

Run from the repository root on a machine with a card:

    python3 flash_d96_ab.py

The committed instance (``src/repro_torch/kernels/csrc/
flash_attention_wgmma.cu``, D = 96) runs P V as wgmma m64n96k16, whose
MN-major V spans one 128-byte swizzle atom and the first half of the next.
This builds the other route, P V at n128 over V's columns 96..127, which
TMA zero-fills, from a text rewrite of the source (``REWRITES``) into the
gitignored ``build/flash_d96_ab/``; the committed kernel is not touched.
It holds the variant against the plain version at the flash bars, then
times both in turns (committed, variant, variant, committed) at
phi3_mini's attention, at [2, 8, 1024, 96] and at [4, 32, 2048, 96], with
``chip_smoke.kernel_ms`` (the profiler's device time). Without a card it
exits 1 and prints nothing else.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SOURCE = "flash_attention_wgmma"
OUT = os.path.join(ROOT, "build", "flash_d96_ab")
# The D = 96 instance's accumulator and P V product at n128: (the
# committed text, the variant's).
N128 = "(D == 96 ? 128 : D) / 2"
REWRITES = [
    ("void wgmma_pv(float (&o)[D / 2],", f"void wgmma_pv(float (&o)[{N128}],"),
    ("    wgmma_m64n96k16_rs_tb(o, a0, a1, a2, a3, desc_v, 1);",
     "    wgmma_m64n128k16_rs_tb(o, a0, a1, a2, a3, desc_v, 1);"),
    ("    float o[D / 2];\n#pragma unroll\n    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;",
     f"    float o[{N128}];\n#pragma unroll\n    for (int i = 0; i < {N128}; ++i) o[i] = 0.f;"),
]
# (b, s, h, kv) at head_dim 96: phi3_mini's served attention, the kernel
# table's shape and a long one.
TIMED = [cs.PHI3_ATTN_SHAPE[:4], cs.FMA_HEAD_TIMED, (4, 2048, 32, 8)]
CHECKED = [((2, 200, 8, 2), True, None), ((2, 200, 4, 4), False, None),
           ((1, 1000, 8, 2), True, None), ((2, 128, 8, 2), True, 320)]


def n128_source(src: str) -> str:
    """The source with the D = 96 instance's P V at n128."""
    for old, new in REWRITES:
        if src.count(old) != 1:
            raise RuntimeError(f"{SOURCE}.cu no longer has {old!r} once")
        src = src.replace(old, new)
    return src


def build_variant() -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, f"{SOURCE}_n128.cu")
    with open(src, "w") as f:
        f.write(n128_source((_build.CSRC / f"{SOURCE}.cu").read_text()))
    lib = os.path.join(OUT, f"{SOURCE}_n128.so")
    # The kernel renamed: two loaded libraries that define one kernel
    # symbol launch each other's kernels.
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
           "-Dfa_wgmma_kernel=fa_wgmma_kernel_n128", "-o", lib, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the n128 variant:\n{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Li96E" in line or ("registers" in line and "96" in line):
            print(f"[ab] {line.strip()[:160]}")
    return ctypes.CDLL(lib)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_d96_ab: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(f"[ab] {cs.card_line()}")
    libs = {"n96 (committed)": _build.load(SOURCE), "n128": build_variant()}
    gen = torch.Generator().manual_seed(0)
    try:
        _build._libs[SOURCE] = libs["n128"]
        for (b, s, h, kv), causal, sk in CHECKED:
            cs.check_kernel(fa.flash_attention_wgmma, gen, (b, s, h, kv, 96),
                            torch.bfloat16, causal, device, sk=sk)
        for b, s, h, kv in TIMED:
            q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                       for x in cs._qkv(gen, b, s, h, kv, 96, torch.bfloat16,
                                        device))
            times = []
            for name in ("n96 (committed)", "n128", "n128", "n96 (committed)"):
                _build._libs[SOURCE] = libs[name]
                ms = cs.kernel_ms(lambda: fa.flash_attention_wgmma(q, k, v))
                times.append(f"{name} {'not measured' if ms is None else f'{ms:.4f}'}")
            print(f"[ab] q [{b}, {h}, {s}, 96], kv {kv} heads, causal bf16, "
                  f"device ms: {'; '.join(times)}")
    finally:
        _build._libs[SOURCE] = libs["n96 (committed)"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
