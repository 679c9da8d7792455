#!/usr/bin/env python3
"""Where the time of wkv6's tensor-core kernel goes, on one CUDA card.

Run from the repository root on a machine with a card:

    python3 wkv6_phases.py

It builds two kinds of variants of ``src/repro_torch/kernels/csrc/wkv6.cu``
into the gitignored ``build/wkv6_phases/`` (the source is rewritten as text;
the committed kernel is not touched) and runs them on rwkv6's shapes, bf16:

- a phase profile: ``clock64`` read at every barrier of the chunk loop by
  thread 0 (warp 0: the diagonal blocks) and thread 128 (warp 4: the other
  operands) of CTA 0, in cycles per chunk for each phase and each wait;
- ablations: the device time with one phase's loop removed (the outputs
  are then wrong; only the time is read), beside the kernel as it is.

The device times come from ``chip_smoke.kernel_ms`` (the profiler). Without
a card it exits 1 and prints nothing else.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402

OUT = os.path.join(ROOT, "build", "wkv6_phases")
SHAPES = [cs.WKV6_SERVED[:4], cs.WKV6_LONG[:4]]   # (b, h, t, k)
# Each ablation: the loop head it empties, in the kernel's own text.
ABLATIONS = {
    "scan": "for (int q = 0; q < L / 4; ++q) {\n        const float x",
    "operands": "for (int i = tid - THREADS / 2; i < L * K; i += THREADS / 2) {",
    "diagonal": "for (int n = 0; n <= SUB; ++n) {",
    "off-diagonal": "if (warp < 2) {\n      float d[4]",
    "r_dec @ state": "for (int i = 0; i < K / 16; ++i) {\n      const int c = 32 * chh + 8 * i + 2 * t;\n      const TF<2>",
    "P @ v": "for (int kk = chh; kk < 2 * m + 2; kk += 2) {",
    "state update": "for (int kk = 0; kk < L / 8; ++kk) {",
}
PHASES = ["issue, wait", "barrier", "la", "barrier", "operands | diagonal",
          "barrier", "off-diagonal, r_dec", "barrier", "P @ v, state", "barrier",
          "store"]


def _empty_loop(src: str, head: str) -> str:
    """``src`` with the loop (or branch) that starts at ``head`` never run."""
    if head not in src:
        raise RuntimeError(f"wkv6.cu no longer has {head!r}")
    if head.startswith("if ("):
        return src.replace(head, head.replace("if (", "if (false && ", 1), 1)
    init, cond, step = head.split("(", 1)[1].split(";")[:3]
    return src.replace(head, head.replace(f";{cond};", "; false;", 1), 1)


def _profiled(src: str) -> str:
    """``src`` with clock64 marks at the tc kernel's barriers and an entry
    ``wkv6_prof`` that reads (or, with reset, zeroes) the sums."""
    head, tc = src.split("namespace tc {", 1)
    start = tc.index("wkv6_tc_kernel(const T* __restrict__ r")
    end = tc.index("template <typename T>\nint launch(")
    parts = tc[start:end].split("__syncthreads();")
    kern = parts[0] + "".join(f"PMARK({2 * i}); __syncthreads(); PMARK({2 * i + 1});" + p
                              for i, p in enumerate(parts[1:]))
    last = kern.rindex("  }\n}\n")
    kern = kern[:last] + f"    PMARK({len(PHASES) - 1});\n" + kern[last:]
    kern = kern.replace("unsigned char sm[];", "unsigned char sm[];\n  long long last_ = clock64();", 1)
    marks = (
        "\n__device__ unsigned long long g_prof[64];\n"
        "#define PMARK(id) do { const long long n_ = clock64(); "
        "if (blockIdx.x == 0 && (threadIdx.x == 0 || threadIdx.x == 128)) "
        "g_prof[(threadIdx.x >> 7) * 32 + (id)] += n_ - last_; last_ = clock64(); } while (0)\n")
    entry = (
        '\nextern "C" int wkv6_prof(unsigned long long* out, int reset) {\n'
        "  unsigned long long zero[64] = {0};\n"
        "  if (reset) return (int)cudaMemcpyToSymbol(tc::g_prof, zero, sizeof(zero));\n"
        "  return (int)cudaMemcpyFromSymbol(out, tc::g_prof, sizeof(zero));\n}\n")
    return head + "namespace tc {" + marks + tc[:start] + kern + tc[end:] + entry


def _build_variant(name: str, src: str):
    """Compile ``src`` as a library of its own; its namespace tc is renamed,
    so that its kernels do not resolve to another loaded library's."""
    d = os.path.join(OUT, name.replace(" ", "_").replace("@", "at"))
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "wkv6.cu"), "w") as f:
        f.write(src)
    shutil.copy(_build.CSRC / "hopper.cuh", os.path.join(d, "hopper.cuh"))
    lib = os.path.join(d, "wkv6.so")
    tag = "".join(ch for ch in name if ch.isalnum())
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, f"-Dtc=tc_{tag}", "-o", lib,
                             os.path.join(d, "wkv6.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv6_phases: no CUDA card", file=sys.stderr)
        return 1
    print(cs.card_line())
    src = (_build.CSRC / "wkv6.cu").read_text()
    variants = {"profile": _profiled(src)}
    variants.update({f"no {k}": _empty_loop(src, h) for k, h in ABLATIONS.items()})
    jobs = {name: _build_variant(name, s) for name, s in variants.items()}
    libs = {"as committed": _build.load("wkv6")}
    for name, (proc, lib) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    prof = libs["profile"].wkv6_prof
    prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    try:
        for shape in SHAPES:
            ins = cs._wkv6_inputs(gen, *shape, torch.bfloat16, dev)
            label = f"r {list(shape)} bf16"
            _build._libs["wkv6"] = libs["profile"]
            wk.wkv6_cuda(*ins)
            prof(None, 1)
            calls = 5
            for _ in range(calls):
                wk.wkv6_cuda(*ins)
            torch.cuda.synchronize()
            sums = (ctypes.c_ulonglong * 64)()
            prof(ctypes.addressof(sums), 0)
            chunks = calls * -(-shape[2] // 32)
            for half, who in ((0, "warp 0"), (1, "warp 4")):
                cyc = [sums[32 * half + i] / chunks for i in range(len(PHASES))]
                print(f"[phases] {label} {who}, cycles a chunk: "
                      + "; ".join(f"{p} {c:.0f}" for p, c in zip(PHASES, cyc))
                      + f"; total {sum(cyc):.0f}")
            times = {}
            for name in ["as committed", *(f"no {k}" for k in ABLATIONS), "as committed"]:
                _build._libs["wkv6"] = libs[name]
                wk.wkv6_cuda(*ins)
                times.setdefault(name, []).append(cs.kernel_ms(lambda: wk.wkv6_cuda(*ins), 10))
            base = sum(times["as committed"]) / 2
            print(f"[ablation] {label}: device ms as committed "
                  + " / ".join(f"{t:.4f}" for t in times["as committed"]) + "; "
                  + "; ".join(f"{n} {t[0]:.4f} ({t[0] - base:+.4f})"
                              for n, t in times.items() if n != "as committed"))
    finally:
        _build._libs["wkv6"] = libs["as committed"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
