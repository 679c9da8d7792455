"""The port's serving path (``repro_torch.launch``, ``repro_torch.serve``)
and its host runtime, held against the JAX package and pinned to it.

Block A of the port (configs, SPSC ring, runtime, Relic core, serve) is the
JAX package's pure-Python host runtime copied with ``repro.`` rewritten to
``repro_torch.``; the fidelity pin below keeps each copy identical to its
source, so a change to one side shows here.
"""

import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
COPIED = [
    "configs/__init__.py", "configs/base.py", "configs/relic_tiny.py",
    "configs/rwkv6_1p6b.py", "configs/zamba2_1p2b.py", "configs/granite_8b.py",
    "configs/qwen3_14b.py", "configs/phi3_mini_3p8b.py", "configs/llama3_405b.py",
    "configs/arctic_480b.py", "configs/llama4_maverick_400b_a17b.py",
    "configs/whisper_large_v3.py", "configs/paligemma_3b.py",
    "core/spsc.py", "core/relic.py", "core/relic_pool.py", "core/schedulers.py",
    "runtime/__init__.py", "runtime/config.py", "runtime/fault.py",
    "runtime/metrics.py", "runtime/chaos.py",
    "serve/__init__.py", "serve/request.py", "serve/metrics.py",
    "serve/ingest.py", "serve/retry.py", "serve/scheduler.py", "serve/loadgen.py",
    "tasks/api.py",
    "stream/__init__.py", "stream/stage.py", "stream/pipeline.py",
    "stream/farm.py", "data/__init__.py", "data/pipeline.py",
]


@pytest.mark.parametrize("path", COPIED)
def test_block_a_copy_matches_reference(path):
    src = (ROOT / "src/repro" / path).read_text()
    port = (ROOT / "src/repro_torch" / path).read_text()
    assert port == src.replace("repro.", "repro_torch."), path


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.launch.serve, repro_torch.models, "
        "repro_torch.kernels.ops, repro_torch.kernels.wkv6, "
        "repro_torch.kernels.ssd, repro_torch.models.rwkv6, "
        "repro_torch.models.mamba2, repro_torch.core, repro_torch.runtime, "
        "repro_torch.quickstart, repro_torch.optim, repro_torch.tasks, "
        "repro_torch.kernels.relic_matmul, repro_torch.launch.train, "
        "repro_torch.checkpoint, repro_torch.data, repro_torch.stream, "
        "repro_torch.tasks.graph, repro_torch.tasks.jsonparse, "
        "repro_torch.workloads, repro_torch.models.moe, "
        "repro_torch.models.encdec, repro_torch.models.convert, "
        "repro_torch.optim.adafactor, repro_torch.optim.compression, "
        "repro_torch.optim.stacks, repro_torch.sharding, "
        "repro_torch.launch.mesh, repro_torch.core.lanes, "
        "repro_torch.core.collective_matmul, repro_torch.core.pipeline, "
        "repro_torch.checkpoint.reshard, repro_torch.elastic_restart, "
        "repro_torch.launch.dryrun, repro_torch.train_lm, "
        "repro_torch.serve_batch, repro_torch.stream_stages\n"
        "from repro_torch.configs import ARCH_IDS, get_config\n"
        "[get_config(a, smoke) for a in ARCH_IDS for smoke in (0, 1)]\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro', "
        "'ml_dtypes') or m.startswith(('jax.', 'repro.', 'ml_dtypes.')))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_stream_layer_has_no_locks():
    """tests/test_stream.py:238-257 on the port: no lock and no MPMC queue
    on the streaming path, the prefetch pipeline or the checkpoint manager;
    composition of 1P1C rings replaces them."""
    import inspect

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import PrefetchPipeline
    from repro_torch.stream import farm, pipeline, stage

    for mod in (stage, pipeline, farm):
        src = inspect.getsource(mod)
        assert "Lock(" not in src, mod.__name__
        assert "queue.Queue" not in src, mod.__name__
    for cls in (PrefetchPipeline, CheckpointManager):
        assert "Lock" not in inspect.getsource(cls), cls.__name__


def test_prefetch_pipeline_and_checkpoint_manager_hold_no_lock(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, PrefetchPipeline, SyntheticLM

    dc = DataConfig(8, 4, 50)
    assert not hasattr(PrefetchPipeline(SyntheticLM(dc), dc), "_push_lock")
    assert not hasattr(CheckpointManager(tmp_path, async_=False), "_write_lock")


# ---------------------------------------------------------------------------
# prefill contract and the serve CLI
# ---------------------------------------------------------------------------

def test_prefill_matches_per_token_decode_loop():
    """make_prefill_step must give the same next-token prediction AND a
    functionally identical cache as feeding the prompt one token at a time
    through serve_step (tests/test_serve.py:436-479, on the port)."""
    cfg = get_config("relic_tiny", smoke=True)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch, plen, gen = 2, 5, 3
    cache_len = plen + gen
    prompts = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (batch, plen)))
    serve_step = make_serve_step(model)
    prefill = make_prefill_step(model)

    cache_ref = model.init_cache(batch, cache_len)
    tok_ref = None
    for t in range(plen):
        tok_ref, _, cache_ref = serve_step(params, cache_ref,
                                           prompts[:, t:t + 1], t)
    cache_pf = model.init_cache(batch, cache_len)
    tok_pf, cache_pf = prefill(params, cache_pf, prompts)

    assert torch.equal(tok_ref, tok_pf)
    for t in range(plen, plen + gen):
        tok_ref, _, cache_ref = serve_step(params, cache_ref, tok_ref, t)
        tok_pf, _, cache_pf = serve_step(params, cache_pf, tok_pf, t)
        assert torch.equal(tok_ref, tok_pf)


def test_prefill_next_token_matches_jax_f32():
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = jget_config("relic_tiny", smoke=True).replace(**f32)
    tcfg = get_config("relic_tiny", smoke=True).replace(**f32)
    jmodel, tmodel = jbuild_model(jcfg), build_model(tcfg, "cpu")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    batch, plen = 3, 7
    prompts = np.random.default_rng(2).integers(0, tcfg.vocab_size, (batch, plen))
    want, _ = jax.jit(jmake_prefill_step(jmodel))(
        jparams, jmodel.init_cache(batch, plen + 1), jnp.asarray(prompts, jnp.int32))
    got, _ = make_prefill_step(tmodel)(
        tparams, tmodel.init_cache(batch, plen + 1), torch.as_tensor(prompts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_cli_returns_batch_by_gen_tokens():
    toks = serve.main(["--arch", "relic_tiny", "--smoke", "--batch", "2",
                       "--prompt-len", "4", "--gen", "6", "--device", "cpu"])
    assert toks.shape == (2, 6)
    assert int(toks.min()) >= 0 and int(toks.max()) < 512


@pytest.mark.parametrize("arch", ["rwkv6_1p6b", "zamba2_1p2b"])
def test_serve_cli_serves_the_recurrent_families(arch):
    toks = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                       "--prompt-len", "4", "--gen", "6", "--device", "cpu"])
    assert toks.shape == (2, 6)
    assert int(toks.min()) >= 0 and int(toks.max()) < 512


def test_serve_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--smoke", "--device", "cuda"])


def test_serve_cli_raises_for_an_unknown_arch():
    with pytest.raises(ModuleNotFoundError):
        serve.main(["--arch", "no_such_arch", "--smoke", "--device", "cpu"])
    assert get_config("arctic-480b", smoke=True).family == "moe"


@pytest.mark.parametrize("arch", [
    "granite_8b", "qwen3_14b", "phi3_mini_3p8b", "llama3_405b", "arctic_480b",
    "llama4_maverick_400b_a17b", "whisper_large_v3", "paligemma_3b"])
def test_serve_cli_serves_the_other_families(arch):
    """The dense configs, the MoE, the encoder-decoder (frames encoded and
    the cross K/V written before the prefill) and the VLM (text only)."""
    toks = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                       "--prompt-len", "4", "--gen", "6", "--device", "cpu"])
    assert toks.shape == (2, 6)
    assert int(toks.min()) >= 0 and int(toks.max()) < 512


def test_load_model_cuts_depth_and_keeps_width():
    """``n_layers`` cuts the depth (as chip_smoke.py serves granite_8b):
    the first layers' weights are the full-depth draw's, in the serving
    layout."""
    cfg, _, params = serve.load_model("granite_8b", smoke=True, device="cpu",
                                      n_layers=1)
    full_cfg, _, full = serve.load_model("granite_8b", smoke=True, device="cpu")
    assert cfg == full_cfg.replace(n_layers=1) and full_cfg.n_layers == 2
    assert len(params["layers"]) == 1
    assert params["embed"]["table"].dtype == torch.bfloat16
    assert torch.equal(params["layers"][0]["attn"]["wq"],
                       full["layers"][0]["attn"]["wq"])
    toks, _ = serve.run(serve.parse_args(
        ["--arch", "granite_8b", "--smoke", "--batch", "2", "--prompt-len",
         "4", "--gen", "3", "--device", "cpu"]), cfg,
        build_model(cfg, "cpu"), params, torch.device("cpu"))
    assert toks.shape == (2, 3)


# ---------------------------------------------------------------------------
# behaviour of the copied runtime, driven through the port's package
# ---------------------------------------------------------------------------

def test_spsc_ring_is_fifo():
    from repro_torch.core import SpscRing

    ring = SpscRing(8)
    for i in range(5):
        assert ring.push(i)
    assert [ring.pop() for _ in range(5)] == list(range(5))


def test_scheduler_names_match_reference():
    from repro.core import available_schedulers as jnames
    from repro_torch.core import available_schedulers, make_scheduler

    assert available_schedulers() == jnames()
    for name in available_schedulers():
        with make_scheduler(name) as sched:
            assert sched.name == name


def test_serve_scheduler_streams_with_ttft_stamps():
    from repro_torch.serve import STATUS_OK, ServeScheduler

    def stream(n):
        for i in range(n):
            time.sleep(0.002)
            yield i

    with ServeScheduler(lanes=1) as server:
        client = server.open_client("t")
        resps = [client.submit(stream, 4) for _ in range(3)]
        outs = [r.result(timeout=30) for r in resps]
    assert outs == [[0, 1, 2, 3]] * 3
    for r in resps:
        assert r.status == STATUS_OK
        assert r.request.arrival_t <= r.first_result_t < r.complete_t
