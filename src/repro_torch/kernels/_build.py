"""Build the port's CUDA kernels with nvcc at first use and load them with
ctypes (a plain C interface; no PyTorch headers, so a build takes seconds),
and what every kernel wrapper shares: its C entries typed once, the launch
on the tensor's device and stream, and the check that no gradient goes
through a kernel.

Each source under ``csrc/`` becomes one shared library in
``build/repro_torch_kernels/`` at the repository root, named by a hash of its
source, the shared headers under ``csrc/`` (``*.cuh``, ``*.h``) and the
flags, so an edited source or header is rebuilt and an unchanged one is not.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def refuse_grad(name: str, *tensors):
    """Raise if autograd would record this call. The kernels have no
    backward (the CUDA ones return tensors without a ``grad_fn``), and the
    JAX package refuses ``jax.grad`` through its kernels too, so a kernel
    wrapper refuses on every device, the CPU's plain version included."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad(); the "
            f"reference trains with use_kernels=False")


def cp_async_rows(t: torch.Tensor) -> bool:
    """Whether a tensor-core recurrence kernel (ssd's, wkv6's) can read or
    write ``t`` [B, H, T, D] as it lies, 16 bytes a cp.async: D contiguous,
    every other stride a multiple of 16 bytes, the base 16-byte aligned."""
    es = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * es % 16 == 0 for st in t.stride()[:-1]))


def pad4(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its last dim zero-padded to a multiple of 4, the unit the
    CUDA-core recurrence kernels (wkv6's and ssd's first designs) tile
    channels by; ``t`` itself when it already is one."""
    extra = -t.shape[-1] % 4
    return torch.nn.functional.pad(t, (0, extra)) if extra else t


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: named by a hash
    of the source, every header under ``csrc/`` (by name and bytes) and the
    flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted([*CSRC.glob("*.cuh"), *CSRC.glob("*.h")]):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists.
    The compiler's report (registers, shared memory, spills) is kept beside
    the library as ``.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib


def entry(source: str, name: str, argtypes):
    """The C entry ``name`` of ``csrc/<source>.cu``, built, loaded and typed
    once (ctypes keeps the types on the function object)."""
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def on_device(t: torch.Tensor):
    """A context in which ``t``'s card is the current one: a no-op when it
    already is, as on a one-card machine."""
    if t.device.index is None or t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s card, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
