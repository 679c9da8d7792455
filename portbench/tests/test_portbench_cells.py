"""Every cell's traffic at the port's SMOKE sizes on the CPU (the port's
plain paths stand in for its kernels there): a run agrees with the float32
reference, and a run whose timed path is broken underneath comes out not
correct, once for each fault the cell can have."""

import pytest
import torch

from portbench.tests.smoke import CELLS, run_cell, smoke_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.manual_seed(0)
    return smoke_root(tmp_path_factory.mktemp("smoke"))


@pytest.mark.parametrize("cell", CELLS)
def test_run_agrees_with_the_reference(root, cell):
    r = run_cell(root, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    e2e = set(r["metrics"])
    assert "setup_s" in e2e and len(e2e) >= 2


def _alter_one_token(monkeypatch):
    """The port's log-likelihood of one token altered where it is made."""
    from repro_torch.models import layers

    real = layers.log_likelihood

    def altered(logits, labels):
        ll = real(logits, labels).clone()
        ll[0, ll.shape[1] // 2] += 2.0
        return ll
    monkeypatch.setattr(layers, "log_likelihood", altered)


def _score_half_batch(monkeypatch):
    """The forward runs half of the batch and repeats it for the rest."""
    from repro_torch.models import lm

    real = lm.lm_forward

    def halved(cfg, params, tokens, **kw):
        half = tokens.shape[0] // 2
        logits, aux = real(cfg, params, tokens[:half], **kw)
        return logits.repeat(2, 1, 1), aux
    monkeypatch.setattr(lm, "lm_forward", halved)


def _state_unchanged(monkeypatch):
    """A train step that returns its state unchanged."""
    from repro_torch.launch import steps

    monkeypatch.setattr(steps, "adamw_update",
                        lambda oc, grads, opt, params, step: (params, opt, 0.0))


def _train_half_batch(monkeypatch):
    """Half of the batch left out of the step, the mean over the rest."""
    from repro_torch.launch import steps

    real = steps._grads
    monkeypatch.setattr(steps, "_grads", lambda model, params, batch: real(
        model, params, {k: v[:v.shape[0] // 2] for k, v in batch.items()}))


def _token_altered_in_the_pipeline(monkeypatch):
    """The prefetch pipeline alters one token of a batch it produces."""
    from repro_torch.data import pipeline

    real = pipeline.PrefetchPipeline._produce

    def produce(self, index):
        b = dict(real(self, index))
        if index == 1:
            b["tokens"] = b["tokens"].copy()
            b["tokens"][0, 0] ^= 1
        return b
    monkeypatch.setattr(pipeline.PrefetchPipeline, "_produce", produce)


FAULTS = [("zamba2_1p2b.score_4k", _alter_one_token),
          ("phi3_mini_3p8b.score_2k", _alter_one_token),
          ("zamba2_1p2b.score_4k", _score_half_batch),
          ("phi3_mini_3p8b.score_2k", _score_half_batch),
          ("zamba2_1p2b.train_2k", _state_unchanged),
          ("zamba2_1p2b.train_2k", _train_half_batch),
          ("zamba2_1p2b.train_2k", _token_altered_in_the_pipeline)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_a_fault_underneath_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run_cell(root, cell)
    assert not r["correct"], r["checks"]
