"""The port's train driver (``repro_torch.launch.train``), its data pipeline
(``repro_torch.data``) and its checkpoints (``repro_torch.checkpoint``),
held against the JAX package: the same batches bit for bit, checkpoints
that either package writes and the other restores bit for bit, the loss
falling and ``--resume`` after a crash mid-save, all on the CPU. The crash
tests are the port's counterparts of ``tests/test_checkpoint_crash.py``.
"""

import json
import threading
import warnings
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.data import DataConfig as JDataConfig
from repro.data import PrefetchPipeline as JPrefetchPipeline
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.steps import make_train_state as jmake_train_state
from repro.models import build_model as jbuild_model
from repro_torch.checkpoint import CheckpointCorruptError, CheckpointManager
from repro_torch.checkpoint.manager import FORMAT_VERSION, MANIFEST
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, PrefetchPipeline, SyntheticLM
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_state, make_train_step
from repro_torch.models import build_model
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.optim import OptConfig
from repro_torch.runtime.chaos import FsCrash, FsFaultInjector

CPU = torch.device("cpu")


def _state(scale=1):
    return {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4) * scale,
        "b": torch.full((5,), 0.5 * scale, dtype=torch.bfloat16),
        "n": torch.tensor(scale, dtype=torch.int32),
    }


def _bits(x):
    """(dtype name, shape, raw bytes) of a tensor or an array, bf16
    included."""
    if isinstance(x, torch.Tensor):
        raw = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return (str(x.dtype).removeprefix("torch."), tuple(x.shape),
                raw.numpy().tobytes())
    a = np.asarray(x)
    return str(a.dtype), a.shape, a.tobytes()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _assert_tree_bits(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert set(la) == set(lb)
    for k in la:
        assert _bits(la[k]) == _bits(lb[k]), k


def _quiet_mgr(d, **kw):
    kw.setdefault("async_", False)
    return CheckpointManager(d, **kw)


def _restore(mgr, **kw):
    return mgr.restore(_state(0), device="cpu", **kw)


# ------------------------------------------------------------ the driver


def test_training_reduces_loss():
    """tests/test_system.py:13-19 on the port, on the CPU."""
    final = train.main(["--arch", "relic_tiny", "--smoke", "--steps", "100",
                        "--batch", "8", "--seq", "64", "--log-every", "50",
                        "--device", "cpu"])
    assert final < 5.0, final  # ln(512) ≈ 6.24 at init


def test_train_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        train.main(["--smoke", "--steps", "1"])


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_train_resume_after_mid_save_kill(tmp_path, capsys):
    """tests/test_checkpoint_crash.py:277-307 on the port: chaos-kill the run
    mid-save, then --resume from the last published step, whose files a
    fresh manager restores bit for bit."""
    ckpt = str(tmp_path / "ckpt")
    common = ["--arch", "relic_tiny", "--smoke", "--batch", "4",
              "--seq", "32", "--log-every", "50",
              "--ckpt", ckpt, "--ckpt-every", "5", "--device", "cpu"]
    with pytest.raises(FsCrash):
        train.main(common + ["--steps", "20", "--ckpt-chaos", "manifest:1"])
    dirs = sorted(p.name for p in Path(ckpt).glob("step_*"))
    assert "step_00000005" in dirs
    assert "step_00000010" not in dirs
    mgr = CheckpointManager(ckpt, async_=False)
    assert mgr.latest_step() == 5
    doc = json.loads((Path(ckpt) / "step_00000005" / MANIFEST).read_text())
    files = {}
    for key, ent in doc["entries"].items():
        arr = np.load(Path(ckpt) / "step_00000005" / ent["file"])
        assert zlib.crc32(np.ascontiguousarray(arr).tobytes()) == ent["crc32"]
        files[key] = arr
    # What --resume restores (through convert, onto the device) is the
    # published files, bit for bit.
    cfg = get_config("relic_tiny", smoke=True)
    template = train_state_to_numpy(make_train_state(
        build_model(cfg, CPU), torch.Generator().manual_seed(0)))
    tree, step = mgr.restore(template, device="cpu")
    back = dict(_leaves(train_state_to_numpy(
        train_state_from_numpy(cfg, tree, CPU))))
    assert step == 5 and set(back) == set(files)
    for key, arr in files.items():
        assert back[key].tobytes() == arr.tobytes(), key
    loss = train.main(common + ["--steps", "20", "--resume"])
    assert "resumed from step 5" in capsys.readouterr().out
    assert np.isfinite(loss)


# --------------------------------------------------------------- the data


def test_synthetic_batches_through_prefetch_match_the_reference():
    """SyntheticLM through the Relic-prefetched pipeline gives the
    reference's batches bit for bit, in order."""
    dc, jdc = DataConfig(16, 4, 512), JDataConfig(16, 4, 512)
    pipe = PrefetchPipeline(SyntheticLM(dc), dc).start()
    jpipe = JPrefetchPipeline(JSyntheticLM(jdc), jdc).start()
    try:
        for _ in range(12):
            got, want = pipe.next_batch(), jpipe.next_batch()
            assert set(got) == set(want) == {"tokens", "labels", "mask"}
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes(), k
    finally:
        pipe.stop()
        jpipe.stop()


# ---------------------------------------------- checkpoints both ways


def _jax_smoke_state():
    model = jbuild_model(jget_config("relic_tiny", smoke=True))
    return jmake_train_state(model, jax.random.PRNGKey(0))


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    jstate = _jax_smoke_state()
    mgr = JCheckpointManager(tmp_path, async_=False)
    mgr.save(jstate, 3)
    cfg = get_config("relic_tiny", smoke=True)
    want = train_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate), CPU)
    tree, step = CheckpointManager(tmp_path, async_=False).restore(
        train_state_to_numpy(want), device="cpu")
    got = train_state_from_numpy(cfg, tree, CPU)
    assert step == 3 and got["step"] == want["step"] == 0
    _assert_tree_bits(train_state_to_numpy(got), train_state_to_numpy(want))


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    cfg = get_config("relic_tiny", smoke=True)
    model = build_model(cfg, CPU)
    state = make_train_state(model, torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in
             SyntheticLM(DataConfig(16, 4, cfg.vocab_size)).batch(0).items()}
    state, _ = make_train_step(model, OptConfig(warmup_steps=2))(state, batch)
    tree = train_state_to_numpy(state)
    CheckpointManager(tmp_path, async_=False).save(tree, 1)
    restored, step = JCheckpointManager(tmp_path, async_=False).restore(
        _jax_smoke_state())
    assert step == 1
    _assert_tree_bits(jax.tree.map(np.asarray, restored), tree)


def test_bfloat16_leaf_round_trips_both_ways(tmp_path):
    vals = np.random.default_rng(0).normal(size=(3, 7)).astype(np.float32)
    # the reference writes, the port reads a torch.bfloat16 tensor
    jtree = {"p": {"w": jnp.asarray(vals, jnp.bfloat16)},
             "step": jnp.int32(4)}
    JCheckpointManager(tmp_path / "j", async_=False).save(jtree, 4)
    doc = json.loads((tmp_path / "j" / "step_00000004" / MANIFEST).read_text())
    assert doc["entries"]["p/w"]["dtype"] == "bfloat16"
    got, _ = CheckpointManager(tmp_path / "j", async_=False).restore(
        {"p": {"w": None}, "step": None}, device="cpu")
    assert got["p"]["w"].dtype == torch.bfloat16
    assert _bits(got["p"]["w"]) == _bits(jax.tree.map(np.asarray, jtree)["p"]["w"])
    # the port writes a bf16 tensor, the reference reads a bf16 array
    ttree = {"p": {"w": torch.from_numpy(vals).to(torch.bfloat16)},
             "step": torch.tensor(4, dtype=torch.int32)}
    CheckpointManager(tmp_path / "t", async_=False).save(ttree, 4)
    back, _ = JCheckpointManager(tmp_path / "t", async_=False).restore(jtree)
    assert back["p"]["w"].dtype == jnp.bfloat16
    assert np.asarray(back["p"]["w"]).tobytes() == \
        ttree["p"]["w"].view(torch.int16).numpy().tobytes()
    assert int(back["step"]) == 4


class _HeldSerialize:
    """A chaos hook that holds every save at its first write point until
    ``release`` is set: the serialize stage then runs after the caller has
    moved on."""

    def __init__(self):
        self.release = threading.Event()

    def at(self, point, step):
        if point == "serialize-start":
            assert self.release.wait(60)

    def entry_written(self, path, step):
        pass

    def write_manifest(self, path, text, step):
        path.write_text(text)


def test_async_save_owns_its_copy_of_the_state(tmp_path):
    """An async save at step k, then more in-place steps before the save is
    written: the checkpoint holds step k exactly. On the CPU
    ``train_state_to_numpy`` aliases the f32 leaves outside ``layers``, so a
    manager that kept its arrays would write a later step."""
    cfg = get_config("relic_tiny", smoke=True)
    model = build_model(cfg, CPU)
    state = make_train_state(model, torch.Generator().manual_seed(0))
    step_fn = make_train_step(model, OptConfig(warmup_steps=2))
    src = SyntheticLM(DataConfig(16, 4, cfg.vocab_size))

    def batch(i):
        return {k: torch.as_tensor(v) for k, v in src.batch(i).items()}

    for i in range(2):
        state, _ = step_fn(state, batch(i))
    mgr = CheckpointManager(tmp_path)              # async, on Relic
    hold = _HeldSerialize()
    mgr._chaos_fs = hold
    live = train_state_to_numpy(state)
    snapshot = jax.tree.map(np.copy, live)
    mgr.save(live, 2)
    for i in range(2, 5):
        state, _ = step_fn(state, batch(i))        # in place
    # the live tree moved (it aliases the parameters), the snapshot did not
    assert not np.array_equal(live["params"]["embed"]["table"],
                              snapshot["params"]["embed"]["table"])
    hold.release.set()
    mgr.wait()
    mgr.close()
    restored, step = CheckpointManager(tmp_path, async_=False).restore(
        snapshot, device="cpu")
    assert step == 2
    _assert_tree_bits(restored, snapshot)


# ------------------------------------------------------- crash coverage


def _tear_manifest(d):
    man = d / MANIFEST
    man.write_text(man.read_text()[:25])


def _future_manifest(d):
    man = d / MANIFEST
    doc = json.loads(man.read_text())
    doc["format_version"] = FORMAT_VERSION + 97
    man.write_text(json.dumps(doc))


@pytest.mark.parametrize("damage,warns", [(_tear_manifest, "skipping"),
                                          (_future_manifest, "format_version")])
def test_latest_step_skips_an_invalid_manifest(tmp_path, damage, warns):
    """A torn manifest and one of an unknown future format are skipped with
    a warning; restore falls back to the valid step."""
    mgr = _quiet_mgr(tmp_path, keep=0)
    mgr.save(_state(1), 1)
    mgr.save(_state(2), 2)
    damage(tmp_path / "step_00000002")
    fresh = _quiet_mgr(tmp_path)
    with pytest.warns(RuntimeWarning, match=warns):
        assert fresh.latest_step() == 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        restored, step = _restore(fresh)
    assert step == 1
    _assert_tree_bits(restored, _state(1))


def test_manifest_carries_format_version_and_crc(tmp_path):
    _quiet_mgr(tmp_path).save(_state(3), 7)
    doc = json.loads((tmp_path / "step_00000007" / MANIFEST).read_text())
    assert doc["format_version"] == FORMAT_VERSION
    assert doc["checksum"] is True and doc["hosts"] == 1
    assert doc["entries"]["b"]["dtype"] == "bfloat16"
    for ent in doc["entries"].values():
        assert isinstance(ent["crc32"], int)
        assert ent["nbytes"] > 0


def _flip(path):
    raw = bytearray(path.read_bytes())
    raw[-3] ^= 0xFF                              # flip payload bits
    path.write_bytes(bytes(raw))


def _truncate(path):
    path.write_bytes(path.read_bytes()[:10])     # mid-file kill


@pytest.mark.parametrize("entry,damage", [("w.npy", _flip), ("b.npy", _truncate),
                                          ("n.npy", _flip)])
def test_corrupt_entry_fails_explicit_restore_then_falls_back(tmp_path, entry,
                                                              damage):
    mgr = _quiet_mgr(tmp_path, keep=0)
    mgr.save(_state(1), 1)
    mgr.save(_state(2), 2)
    damage(tmp_path / "step_00000002" / entry)
    fresh = _quiet_mgr(tmp_path)
    # explicit step: the caller asked for exactly this state — raise
    with pytest.raises(CheckpointCorruptError):
        _restore(fresh, step=2)
    # latest-wins: quarantine + fall back
    with pytest.warns(RuntimeWarning, match="quarantined"):
        restored, step = _restore(fresh)
    assert step == 1
    _assert_tree_bits(restored, _state(1))
    assert len(list(tmp_path.glob("step_00000002.corrupt*"))) == 1
    assert not (tmp_path / "step_00000002").exists()


def test_unknown_entry_dtype_is_corrupt(tmp_path):
    mgr = _quiet_mgr(tmp_path, keep=0)
    mgr.save(_state(1), 1)
    mgr.save(_state(2), 2)
    man = tmp_path / "step_00000002" / MANIFEST
    doc = json.loads(man.read_text())
    doc["entries"]["w"]["dtype"] = "float37"
    man.write_text(json.dumps(doc))
    with pytest.raises(CheckpointCorruptError, match="float37"):
        _restore(_quiet_mgr(tmp_path), step=2)


def test_all_corrupt_raises_filenotfound(tmp_path):
    mgr = _quiet_mgr(tmp_path)
    mgr.save(_state(1), 1)
    _flip(tmp_path / "step_00000001" / "w.npy")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(FileNotFoundError, match="quarantined"):
            _restore(_quiet_mgr(tmp_path))


def test_checksum_off_writes_v1_compatible_entries(tmp_path):
    _quiet_mgr(tmp_path, checksum=False).save(_state(4), 3)
    doc = json.loads((tmp_path / "step_00000003" / MANIFEST).read_text())
    assert all("crc32" not in e for e in doc["entries"].values())
    restored, step = _restore(_quiet_mgr(tmp_path))
    assert step == 3
    _assert_tree_bits(restored, _state(4))


@pytest.mark.parametrize("async_", [False, True])
def test_restore_is_bit_identical(tmp_path, async_):
    mgr = CheckpointManager(tmp_path, async_=async_)
    mgr.save(_state(13), 11, block=True)
    mgr.close()
    restored, step = _restore(_quiet_mgr(tmp_path))
    assert step == 11
    _assert_tree_bits(restored, _state(13))
    assert restored["b"].dtype == torch.bfloat16
    assert restored["n"].dtype == torch.int32 and restored["n"].shape == ()


def test_restore_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    _quiet_mgr(tmp_path).save(_state(1), 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        _quiet_mgr(tmp_path).restore(_state(0))


def test_gc_never_collects_last_valid_checkpoint(tmp_path):
    mgr = _quiet_mgr(tmp_path, keep=1)
    mgr.save(_state(1), 1)
    torn = tmp_path / "step_00000002"
    torn.mkdir()
    (torn / MANIFEST).write_text('{"step": 2, "ent')    # torn
    mgr._gc()
    assert (tmp_path / "step_00000001").exists()        # spared
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert _quiet_mgr(tmp_path).latest_step() == 1


def test_gc_ignores_quarantined_dirs(tmp_path):
    mgr = _quiet_mgr(tmp_path, keep=2)
    for s in (1, 2, 3):
        mgr.save(_state(s), s)
    (tmp_path / "step_00000009.corrupt").mkdir()
    mgr._gc()
    assert (tmp_path / "step_00000009.corrupt").exists()
    assert not (tmp_path / "step_00000001").exists()    # normal retention
    assert (tmp_path / "step_00000003").exists()


@pytest.mark.parametrize("torn", [None, 7])
@pytest.mark.parametrize("at_save", [0, 1, 2])
@pytest.mark.parametrize("point", FsFaultInjector.POINTS)
def test_crash_point_sweep_always_restores_valid_step(tmp_path, point, at_save,
                                                      torn):
    """Kill a save at every serialize/publish boundary (and mid-file)
    across a sequence of saves: restore returns a complete, checksum-valid
    earlier step, never a torn one."""
    mgr = _quiet_mgr(tmp_path, keep=0)
    FsFaultInjector(crash_point=point, at_save=at_save, at_index=1,
                    torn_bytes=torn).arm(mgr)
    published = 0
    try:
        for step in (1, 2, 3, 4):
            mgr.save(_state(step), step)
            published = step
    except FsCrash:
        pass
    assert published == at_save
    fresh = _quiet_mgr(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if published == 0:
            assert fresh.latest_step() is None
            with pytest.raises(FileNotFoundError):
                _restore(fresh)
        else:
            assert fresh.latest_step() == published
            restored, got = _restore(fresh)
            assert got == published
            _assert_tree_bits(restored, _state(published))
