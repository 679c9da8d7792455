"""Fault-tolerant checkpointing, in the reference's on-disk format.

The port of ``src/repro/checkpoint/manager.py``. A checkpoint that either
package writes, the other restores: the same v2 manifest, the same
``.npy`` entries under the same key paths (``params/...``, ``opt/mu/...``,
``opt/nu/...``, ``step``, as ``models.convert.train_state_to_numpy``
gives them), bf16 entries stored as ``uint16`` views with ``"dtype":
"bfloat16"``. Only the JAX parts are rewritten: trees are nested dicts
flattened by plain recursion; ``save`` takes tensors (on any device) or
numpy arrays and copies every one to the host before it returns, so an
in-place update after ``save`` never reaches the files (the port's AdamW
updates in place, and ``convert.train_state_to_numpy`` aliases CPU
tensors; ``jax.device_get`` gives the reference that copy for free);
``restore`` returns tensors on the device it is given.

Design (as the reference's):
  * atomic: write into ``step_<n>.tmp`` then ``os.replace`` to ``step_<n>``;
    a manifest is the last file written, so a partially-written checkpoint is
    never restorable.
  * asynchronous: the copy to host memory happens on the main thread,
    then the save flows through a two-stage
    streaming pipeline (`repro_torch.stream`): a **serialize** stage writes the
    tmp dir, a **publish** stage atomically renames and GCs — so
    back-to-back `save()` calls overlap (save N+1 serializes while save N
    publishes) instead of serializing behind a lock, and training
    continues while bytes hit disk (`wake_up_hint` before the save
    window, `sleep_hint` after). This is a production use of the paper's
    API, not a demo.
  * retention: keep the newest ``keep`` checkpoints — but never collect
    the last manifest-valid one, even when ``keep`` would (a retention
    sweep must not delete the only thing ``--resume`` can use).
  * crash-consistent restore: the manifest carries ``format_version`` and
    (by default, ``RELIC_CKPT_CHECKSUM``) a CRC32 per entry over the
    stored bytes. ``latest_step()`` only counts steps whose manifest
    *parses and validates* (a torn ``manifest.json`` is skipped with a
    warning, not raised); ``restore()`` verifies entry checksums and falls
    back to the next-latest valid step, quarantining a corrupt dir as
    ``<dir>.corrupt`` (kept for post-mortem, never deleted) rather than
    restoring torn state. Crash points are deterministically testable via
    ``repro_torch.runtime.chaos.FsFaultInjector``.
  * one card, one host (``"hosts": 1`` in the manifest); resharding onto
    another topology (``checkpoint/reshard.py``) is not ported.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import warnings
import zlib
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.schedulers import Scheduler
from repro_torch.devices import resolve_device
from repro_torch.runtime.config import resolve_checkpoint_config
from repro_torch.stream import Pipeline, Stage, StreamFailure
from repro_torch.tasks.api import TaskGroupError

MANIFEST = "manifest.json"
#: Manifest schema version. 1 = pre-checksum (implicit — no
#: ``format_version`` key); 2 = per-entry ``crc32``/``nbytes`` +
#: ``format_version``. Restore accepts both; an *unknown* (future) version
#: is treated like a torn manifest: skip-and-warn, fall back.
FORMAT_VERSION = 2


class CheckpointCorruptError(RuntimeError):
    """A specific requested checkpoint failed validation (torn manifest,
    missing entry file, CRC mismatch). Only raised for an *explicit*
    ``restore(step=...)`` — latest-wins restore falls back instead."""


def _flat(tree, prefix: str = "") -> dict[str, Any]:
    """Leaves of nested dicts by their ``/``-joined key paths (in sorted
    key order, as ``jax.tree_util`` flattens a dict)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    flat = {}
    for k in sorted(tree):
        flat.update(_flat(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _unflat_into(template, flat: dict, prefix: str = ""):
    if not isinstance(template, dict):
        return flat[prefix]
    return {k: _unflat_into(v, flat, f"{prefix}/{k}" if prefix else str(k))
            for k, v in template.items()}


def _host_copy(leaf) -> Tuple[str, np.ndarray]:
    """(logical dtype, a host array this save owns): a tensor on any device
    or an array, copied. bf16, which numpy lacks, becomes a ``uint16``
    view, as the reference stores its ml_dtypes arrays."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).to("cpu", copy=True).numpy()
            return "bfloat16", bits.view(np.uint16)
        arr = t.to("cpu", copy=True).numpy()
        return str(arr.dtype), arr
    arr = np.array(leaf, copy=True)
    logical = str(arr.dtype)
    if arr.dtype.kind not in "biufc":  # ml_dtypes (bfloat16, fp8...)
        arr = arr.view(np.dtype(f"u{arr.dtype.itemsize}"))
    return logical, arr


def _to_tensor(arr: np.ndarray, logical: str, device: torch.device) -> torch.Tensor:
    """A stored entry as a tensor of its logical dtype on ``device``."""
    arr = np.asarray(arr, order="C")
    if logical == "bfloat16":  # stored as a uint16 view
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    if arr.dtype != np.dtype(logical):
        arr = arr.view(np.dtype(logical))
    return torch.from_numpy(arr).to(device)


class CheckpointManager:
    """``scheduler`` selects the host-overlap substrate for async saves: a
    ``repro_torch.core.schedulers`` registry name or a not-yet-started
    ``Scheduler`` instance (default: the paper's Relic runtime).

    Async saves flow through a 2-stage :class:`repro_torch.stream.Pipeline`
    (serialize → publish). A registry name hosts each stage on its own
    assistant, so consecutive saves overlap; an instance substrate fuses
    both stages onto its single worker; ``"serial"`` (or ``async_=False``)
    writes synchronously on the caller. Each in-flight save serializes
    into a *sequence-unique* tmp dir (``step_<n>.tmp-<seq>``), so two
    overlapped saves of the same step never collide; the publish stage is
    the single FIFO owner of rename + GC, preserving the atomicity
    invariant (manifest last, ``os.replace`` to the final name) without
    the old ``_write_lock`` — one owner per resource instead of one lock
    around all of them.
    """

    def __init__(self, directory: str | Path, keep: int = 3,
                 async_: bool = True, scheduler: "str | Scheduler" = "relic",
                 checksum: Optional[bool] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_ = async_
        self.checksum = resolve_checkpoint_config(checksum=checksum).checksum
        self._seq = 0          # distinguishes overlapped tmp dirs
        self._pending = 0      # saves fed but not yet collected by wait()
        self._pipe: Optional[Pipeline] = None
        # Opt-in chaos hook (None in production): consulted at the named
        # filesystem crash points of _serialize/_publish. See
        # repro_torch.runtime.chaos.FsFaultInjector.
        self._chaos_fs: Optional[Any] = None
        if async_:
            if isinstance(scheduler, str):
                nodes = [
                    Stage(self._serialize, name="ckpt-serialize",
                          capacity=4, substrate=scheduler),
                    Stage(self._publish, name="ckpt-publish",
                          capacity=4, substrate=scheduler),
                ]
            else:
                def serialize_publish(item: tuple) -> int:
                    return self._publish(self._serialize(item))
                nodes = [Stage(serialize_publish, name="ckpt-write",
                               capacity=4, substrate=scheduler)]
            self._pipe = Pipeline(nodes, capacity=4).start()
            self._pipe.pause()   # park until the first save window

    # ------------------------------------------------------------------ save

    def save(self, state, step: int, *, block: bool = False) -> None:
        """Save ``state`` (nested dicts of tensors or arrays) as ``step``.
        Every leaf is copied to the host before this returns."""
        host = {k: _host_copy(v) for k, v in _flat(state).items()}
        seq = self._seq
        self._seq += 1
        if self._pipe is not None:
            self._pipe.resume()
            self._pipe.put((seq, host, step))
            self._pending += 1
            if block:
                self.wait()
        else:
            self._publish(self._serialize((seq, host, step)))

    def wait(self) -> None:
        """Drain outstanding saves; re-raises write errors (several failed
        saves surface together as ``TaskGroupError``)."""
        if self._pipe is None:
            return
        errors: List[BaseException] = []
        while self._pending:
            out = self._pipe.get_raw()
            self._pending -= 1
            if type(out) is StreamFailure:
                errors.append(out.error)
        self._pipe.pause()
        if len(errors) == 1:
            raise errors[0]
        if errors:
            raise TaskGroupError(errors)

    def _serialize(self, item: tuple) -> tuple:
        """Stage 1: write the tmp dir (the byte-heavy half of a save)."""
        seq, host, step = item
        fs = self._chaos_fs
        if fs is not None:
            fs.at("serialize-start", step)
        tmp = self.dir / f"step_{step:08d}.tmp-{seq}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        entries = {}
        for key, (logical, arr) in host.items():
            fname = key.replace("/", "__") + ".npy"
            np.save(tmp / fname, arr)
            ent = {"file": fname, "shape": list(arr.shape),
                   "dtype": logical}
            if self.checksum:
                # CRC over the stored payload bytes (post uint view): the
                # same bytes restore hashes after np.load, so a torn or
                # bit-flipped entry file cannot verify.
                stored = np.ascontiguousarray(arr)
                ent["crc32"] = zlib.crc32(stored.tobytes())
                ent["nbytes"] = int(stored.nbytes)
            entries[key] = ent
            if fs is not None:
                fs.entry_written(tmp / fname, step)
        manifest = {"format_version": FORMAT_VERSION, "step": step,
                    "time": time.time(), "entries": entries, "hosts": 1,
                    "checksum": self.checksum}
        text = json.dumps(manifest)
        if fs is not None:
            fs.write_manifest(tmp / MANIFEST, text, step)
        else:
            (tmp / MANIFEST).write_text(text)
        return (step, tmp)

    def _publish(self, item: tuple) -> int:
        """Stage 2: atomic rename + retention GC. Saves pass through here
        in submission order (the pipeline is FIFO), and this stage is the
        sole toucher of final names — the one-writer invariant the old
        ``_write_lock`` bought, now held structurally."""
        step, tmp = item
        fs = self._chaos_fs
        if fs is not None:
            fs.at("pre-publish", step)
        final = self.dir / f"step_{step:08d}"
        if final.exists():  # idempotent re-save of the same step
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        self._gc()
        return step

    def _gc(self) -> None:
        done = sorted(p for p in self.dir.glob("step_*")
                      if ".tmp" not in p.name
                      and not p.name.endswith(".corrupt"))
        if not self.keep:
            return
        drop = done[: -self.keep]
        if drop and not any(
                self._load_manifest(p, warn=False) is not None
                for p in done[-self.keep:]):
            # Retention would delete every manifest-valid checkpoint (the
            # keep window holds only torn ones): spare the newest valid
            # dir below the window — --resume must always have something.
            spare = next((p for p in reversed(drop)
                          if self._load_manifest(p, warn=False) is not None),
                         None)
            if spare is not None:
                drop = [p for p in drop if p is not spare]
        for p in drop:
            shutil.rmtree(p, ignore_errors=True)

    # --------------------------------------------------------------- restore

    def _load_manifest(self, d: Path, warn: bool = True) -> Optional[dict]:
        """Parse and validate ``d``'s manifest; None (optionally with a
        warning) when it is missing, torn, structurally wrong, or written
        by an unknown future format — the skip-and-warn primitive
        ``latest_step``/``restore`` build their fallback on."""
        why = None
        manifest: Optional[dict] = None
        try:
            manifest = json.loads((d / MANIFEST).read_text())
        except FileNotFoundError:
            return None                 # mid-write dir: not even a warning
        except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
            why = f"unreadable manifest ({e})"
        if why is None:
            if not isinstance(manifest, dict):
                why = "manifest is not an object"
            elif not isinstance(manifest.get("entries"), dict) \
                    or not isinstance(manifest.get("step"), int):
                why = "manifest missing step/entries"
            elif manifest.get("format_version", 1) > FORMAT_VERSION:
                why = (f"unknown format_version "
                       f"{manifest.get('format_version')}")
        if why is not None:
            if warn:
                warnings.warn(
                    f"checkpoint {d.name}: {why}; skipping it",
                    RuntimeWarning, stacklevel=3)
            return None
        return manifest

    def valid_steps(self) -> List[int]:
        """Steps with a parseable, schema-valid manifest, ascending.
        (Manifest-valid, not checksum-verified — entry payloads are only
        hashed when actually restored.)"""
        steps = []
        for p in sorted(self.dir.glob("step_*")):
            if ".tmp" in p.name or p.name.endswith(".corrupt"):
                continue
            if self._load_manifest(p) is None:
                continue
            steps.append(int(p.name.split("_")[1]))
        return steps

    def latest_step(self) -> Optional[int]:
        steps = self.valid_steps()
        return steps[-1] if steps else None

    def _quarantine(self, d: Path) -> None:
        """Move a corrupt checkpoint dir aside as ``<name>.corrupt`` (kept
        for post-mortem — never deleted, never globbed as a step again)."""
        target = d.with_name(d.name + ".corrupt")
        n = 1
        while target.exists():
            target = d.with_name(f"{d.name}.corrupt-{n}")
            n += 1
        os.replace(d, target)
        warnings.warn(
            f"checkpoint {d.name}: corrupt; quarantined as {target.name}",
            RuntimeWarning, stacklevel=3)

    def _restore_step(self, d: Path, manifest: dict, template,
                      device: torch.device) -> Any:
        """Load one validated manifest's entries, verifying checksums when
        the manifest carries them; raises :class:`CheckpointCorruptError`
        on any torn/mismatched entry."""
        flat_t = _flat(template)
        out = {}
        for key, ent in manifest["entries"].items():
            if key not in flat_t:
                continue  # forward-compat: ignore unknown entries
            try:
                arr = np.load(d / ent["file"])
            except (OSError, ValueError, EOFError) as e:
                raise CheckpointCorruptError(
                    f"{d.name}/{ent['file']}: unreadable ({e})") from e
            if "crc32" in ent:
                stored = np.ascontiguousarray(arr)
                crc = zlib.crc32(stored.tobytes())
                if crc != ent["crc32"] or stored.nbytes != ent["nbytes"]:
                    raise CheckpointCorruptError(
                        f"{d.name}/{ent['file']}: checksum mismatch "
                        f"(crc {crc:#010x} != manifest "
                        f"{ent['crc32']:#010x})")
            try:
                # bf16 etc. stored as raw uint views
                out[key] = _to_tensor(arr, ent["dtype"], device)
            except (TypeError, ValueError) as e:
                raise CheckpointCorruptError(
                    f"{d.name}/{ent['file']}: dtype {ent['dtype']!r} ({e})") from e
        missing = set(flat_t) - set(out)
        if missing:
            raise KeyError(f"checkpoint missing {sorted(missing)[:5]}...")
        return _unflat_into(template, out)

    def restore(self, template, step: Optional[int] = None, *,
                device: Any = "cuda") -> Tuple[Any, int]:
        """Restore into `template`'s structure (nested dicts; only its keys
        are read), every entry a tensor of its stored dtype on ``device``
        (the card unless the caller asks for the CPU).

        With ``step=None`` (latest wins) a checkpoint that fails validation
        — torn manifest, missing or checksum-mismatched entry — is
        quarantined as ``.corrupt`` and the next-latest valid step is
        tried, so a crash mid-save can never brick the resume path. An
        *explicit* ``step=`` that fails validation raises
        :class:`CheckpointCorruptError` instead (the caller asked for that
        exact state; silently substituting another would be worse)."""
        device = resolve_device(device)
        if step is not None:
            d = self.dir / f"step_{step:08d}"
            manifest = self._load_manifest(d)
            if manifest is None:
                if not d.exists():
                    raise FileNotFoundError(f"no checkpoint {d}")
                raise CheckpointCorruptError(
                    f"{d.name}: invalid manifest")
            return self._restore_step(d, manifest, template, device), step
        tried = False
        for s in reversed(self.valid_steps()):
            tried = True
            d = self.dir / f"step_{s:08d}"
            manifest = self._load_manifest(d)
            if manifest is None:
                continue
            try:
                return (self._restore_step(d, manifest, template, device),
                        s)
            except CheckpointCorruptError:
                self._quarantine(d)
        if tried:
            raise FileNotFoundError(
                f"no restorable checkpoint under {self.dir} "
                "(every candidate was corrupt and has been quarantined)")
        raise FileNotFoundError(f"no checkpoint under {self.dir}")

    def close(self) -> None:
        if self._pipe is not None:
            try:
                self.wait()             # surfaces pending write errors
            finally:
                pipe, self._pipe = self._pipe, None
                pipe.close()            # but never leaks the worker threads
