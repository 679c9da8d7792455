"""Offline scoring: a closed loop with one batch in flight. Each batch is
``batch`` documents of ``length`` uniform token ids drawn from the seed; the
port's teacher-forced forward (``Model.forward``, ``lm_forward``, with the
configuration's serving layout: bf16 weights, ``use_kernels``) gives the
logits, the port's ``log_likelihood`` the log-probability of each next
token, and the sum per document is copied to the host. A batch's latency
runs from its submission to its sums on the host.

The check: once the window has closed, ``check_batches`` of the window's
batches, drawn from the seed, are scored again by the float32 reference on
the same weights and tokens, one document at a time, and the port's
per-token log-likelihoods (kept on the card) and per-document sums (as
the host got them) are compared with the reference's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import program, tokens
from portbench.harness.runner import Window
from portbench.harness.weights import derive



class Traffic:
    SPANS = ("forward", "log_likelihood", "sync")   # the benchmark's host spans

    def __init__(self, run):
        self.run = run
        mix = run.cell.traffic
        self.m = run.cell.model(mix["layout"])
        self.batch, self.length = mix["batch"], mix["length"]
        self.reference = run.cell.reference()
        self.next_index = 0
        self.kept = {}          # window batch index -> (ll on the card, host sums)

    # -- the system under test -------------------------------------------
    def setup(self):
        from repro_torch.models import layers

        self.log_likelihood = layers.log_likelihood
        self.model, self.params, self.flat, _ = program.build(
            self.m, self.reference, self.run.seed, self.run.device,
            requires_grad=False, own_rules=self.run.cell.init_rules)
        for _ in range(self.run.cell.traffic["warmup_batches"]):
            self._one()

    def _one(self):
        """Score the next batch: (index, per-token ll on the device, sums on
        the host, submission time, completion time)."""
        run, i = self.run, self.next_index
        self.next_index += 1
        toks = self.batch_tokens(i)
        t0 = time.perf_counter()
        ll = self.score(toks)
        with run.spans("sync"):
            sums = ll.sum(-1).cpu()
        return i, ll, sums, t0, time.perf_counter()

    def score(self, toks: torch.Tensor) -> torch.Tensor:
        """The port's per-token log-likelihoods of documents ``toks``
        [batch, length + 1] (left on the device)."""
        with torch.no_grad():
            with self.run.spans("forward"):
                logits, _ = self.model.forward(self.params, toks[:, :-1])
            with self.run.spans("log_likelihood"):
                return self.log_likelihood(logits, toks[:, 1:])

    def batch_tokens(self, index: int) -> torch.Tensor:
        return tokens.documents(self.run.seed, index, self.batch, self.length,
                                self.m["vocab_size"], self.run.device)

    def window(self, seconds: float) -> Window:
        t0 = time.perf_counter()
        latencies, gaps, last = [], [], t0
        while time.perf_counter() - t0 < seconds:
            i, ll, sums, ts, te = self._one()
            self.kept[i] = (ll, sums)
            latencies.append(te - ts)
            gaps.append(ts - last)
            last = te
        t1 = time.perf_counter()
        return Window(t0, t1, len(latencies),
                      len(latencies) * self.batch * self.length, latencies, gaps)

    def stretch(self):
        for _ in range(self.run.cell.traffic["trace_batches"]):
            self._one()

    def release(self):
        del self.model, self.params, self.flat

    # -- the check ----------------------------------------------------------
    def sample(self) -> list:
        """The window's batches the check scores again, drawn from the seed."""
        order = sorted(self.kept)
        rng = np.random.default_rng(derive(self.run.seed, 3))
        n = min(self.run.cell.traffic["check_batches"], len(order))
        return sorted(order[j] for j in rng.choice(len(order), n, replace=False))

    def reference_ll(self, index: int, w, mm=None) -> torch.Tensor:
        """The reference's per-token log-likelihoods of batch ``index``,
        one document at a time (``mm``: its projections' product, the
        float32 one unless given)."""
        ref, toks = self.reference, self.batch_tokens(index)
        kw = {} if mm is None else {"mm": mm}
        with torch.no_grad(), ref.float32_exact():
            return torch.cat([ref.log_likelihood(self.m, w, toks[r:r + 1, :-1],
                                                 toks[r:r + 1, 1:], **kw)
                              for r in range(self.batch)])

    def gaps(self, outputs: dict, refs: dict) -> dict:
        """{batch index: (per-token ll on the device, host sums)} against
        {batch index: the reference's per-token ll}: the widest per-token
        gap, and the widest per-document gap of the sums over the document's
        length."""
        ll_gap = doc_gap = 0.0
        for i, ref in refs.items():
            ll, sums = outputs[i]
            ll_gap = max(ll_gap, (ll.float() - ref).abs().max().item())
            doc = (sums.double() - ref.double().sum(-1).cpu()).abs().max().item()
            doc_gap = max(doc_gap, doc / self.length)
        return {"ll_gap_max": ll_gap, "doc_mean_gap_max": doc_gap}

    def check(self, check):
        run = self.run
        _, w = program.reference_weights(self.m, self.reference, run.seed,
                                         run.device, run.cell.init_rules)
        refs = {i: self.reference_ll(i, w) for i in self.sample()}
        for name, value in self.gaps(self.kept, refs).items():
            check.add(name, value)
