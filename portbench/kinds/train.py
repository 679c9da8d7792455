"""Training: a closed loop of train steps. The benchmark's seeded token
stream (``tokens.SyntheticLM``) is the source of the port's
``PrefetchPipeline`` (its Relic assistant produces batches ahead of the
loop); each batch is copied to the card as the port's train driver does
and stepped by the port's ``make_train_step`` (the configuration's layout:
float32 weights, bf16 compute, remat; AdamW with the mix's settings,
clipping by the global norm). The window takes all steps issued before
its end and closes when the card has finished them.

Set-up drives the one train state it hands to the window through its
first ``ref_steps`` steps, by the window's own pipeline and step, and keeps
what the check needs: each step's loss, each leaf's norm of the first
gradient as the optimizer got it (its first moment after one step over
``1 - b1``), and each leaf's norm of its change after the last of those
steps. The check runs the float32 reference through the same steps on
the same weights and batches, in blocks of ``ref_rows`` rows, and compares;
it also draws every batch the loop consumed again from the seed and counts
those that differ.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench.harness import program, tokens
from portbench.harness.check import rel_gap, worst_leaf
from portbench.harness.runner import Window



def leaf_norms(flat: torch.Tensor, shapes) -> dict:
    """{name: float norm} of each parameter's slice of ``flat``."""
    norms, off = [], 0
    for _, shape in shapes:
        n = int(np.prod(shape))
        norms.append(flat.narrow(0, off, n).float().norm())
        off += n
    return dict(zip((n for n, _ in shapes), torch.stack(norms).tolist()))


class Traffic:
    SPANS = ("next_batch", "train_step", "sync")   # the benchmark's host spans

    def __init__(self, run):
        self.run = run
        self.mix = run.cell.traffic
        self.m = run.cell.model(self.mix["layout"])
        self.reference = run.cell.reference()
        self.source = tokens.SyntheticLM(run.seed, self.mix["batch"],
                                         self.mix["length"], self.m["vocab_size"])
        self.consumed = []      # the batches the loop took, in order
        self.losses = []        # the first steps' losses
        self.grad_norms = self.change_norms = None

    # -- the system under test -------------------------------------------
    def setup(self):
        from repro_torch.data import DataConfig, PrefetchPipeline
        from repro_torch.optim import init_opt_state

        run, mix = self.run, self.mix
        params = self.build()
        self.state = {"params": params, "opt": init_opt_state(params), "step": 0}
        self.step_fn = self.make_step()
        dc = DataConfig(seq_len=mix["length"], global_batch=mix["batch"],
                        vocab_size=self.m["vocab_size"], seed=run.seed,
                        prefetch=mix["prefetch"])
        self.pipe = PrefetchPipeline(self.source, dc).start()
        start = self.flat.clone()
        for k in range(mix["ref_steps"]):
            metrics = self._step()
            self.losses.append(float(metrics["loss"]))
            if k == 0:
                mu = self.state["opt"]["mu"]
                b1 = mix["opt"]["b1"]
                self.grad_norms = {n: v / (1 - b1) for n, v in zip(
                    (n for n, _ in self.shapes),
                    torch.stack([mu[n].norm() for n, _ in self.shapes]).tolist())}
        start.sub_(self.flat).neg_()
        self.change_norms = leaf_norms(start, self.shapes)
        del start

    def build(self):
        """The program's model and parameters (kept as ``self.model``,
        ``self.flat``, ``self.shapes``)."""
        self.model, params, self.flat, self.shapes = program.build(
            self.m, self.reference, self.run.seed, self.run.device,
            requires_grad=True, own_rules=self.run.cell.init_rules)
        return params

    def make_step(self):
        """The port's train step for the mix's optimizer settings."""
        from repro_torch.launch.steps import make_train_step
        from repro_torch.optim import OptConfig

        return make_train_step(self.model, OptConfig(**self.mix["opt"]))

    def _step(self):
        run = self.run
        with run.spans("next_batch"):
            host = self.pipe.next_batch()
            batch = {k: torch.as_tensor(v).to(run.device) for k, v in host.items()}
        self.consumed.append(host)
        with run.spans("train_step"):
            self.state, metrics = self.step_fn(self.state, batch)
        return metrics

    def _sync(self):
        with self.run.spans("sync"):
            if torch.device(self.run.device).type == "cuda":
                torch.cuda.synchronize()

    def window(self, seconds: float) -> Window:
        t0 = time.perf_counter()
        issued = []
        while time.perf_counter() - t0 < seconds:
            ts = time.perf_counter()
            self._step()
            issued.append(time.perf_counter() - ts)
        self._sync()
        t1 = time.perf_counter()
        n = len(issued)
        return Window(t0, t1, n, n * self.mix["batch"] * self.mix["length"], issued)

    def stretch(self):
        for _ in range(self.mix["trace_steps"]):
            self._step()
        self._sync()

    def release(self):
        self.pipe.stop()
        del self.model, self.state, self.step_fn, self.pipe, self.flat

    # -- the check ----------------------------------------------------------
    def reference_steps(self):
        """The reference through the first ``ref_steps`` steps: (losses,
        each leaf's clipped first gradient norm, each leaf's change norm)."""
        run, mix, ref = self.run, self.mix, self.reference
        from portbench.reference import adamw

        flat, w0 = program.reference_weights(self.m, ref, run.seed, run.device,
                                             run.cell.init_rules)
        w = {n: v.clone().requires_grad_(True) for n, v in w0.items()}
        mu = {n: torch.zeros_like(v) for n, v in w.items()}
        nu = {n: torch.zeros_like(v) for n, v in w.items()}
        rows = mix["batch"]
        losses, first = [], None
        with ref.float32_exact():
            for k in range(mix["ref_steps"]):
                b = self.source.batch(k)
                toks = torch.as_tensor(b["tokens"]).to(run.device)
                labels = torch.as_tensor(b["labels"]).to(run.device)
                loss = 0.0
                for r in range(0, rows, mix["ref_rows"]):
                    ll = ref.log_likelihood(self.m, w, toks[r:r + mix["ref_rows"]],
                                            labels[r:r + mix["ref_rows"]])
                    part = -ll.sum() / ll.numel() * (ll.shape[0] / rows)
                    part.backward()
                    loss += part.item()
                grads = {n: v.grad for n, v in w.items()}
                grads, _ = adamw.clip(grads, mix["opt"]["clip_norm"])
                if k == 0:
                    first = {n: g.norm().item() for n, g in grads.items()}
                adamw.step(mix["opt"], w, grads, mu, nu, k)
                for v in w.values():
                    v.grad = None
                losses.append(loss)
        change = {n: (w[n].detach() - w0[n]).norm().item() for n in w}
        return losses, first, change

    def batches_off(self) -> int:
        """How many of the batches the loop consumed differ from the
        stream's batches, drawn again, in order."""
        return sum(not all(np.array_equal(got[k], want[k]) for k in want)
                   for i, got in enumerate(self.consumed)
                   for want in [self.source.batch(i)])

    def gaps(self, ref) -> dict:
        """The set-up steps' readings against the reference's
        (``reference_steps``). Leaves whose first gradient is nought to
        rounding in the reference (under a thousandth of the median leaf's)
        move by round-off alone and are left out of the change."""
        losses, first, change = ref
        med = float(np.median(list(first.values())))
        moved = {n for n, v in first.items() if v >= 1e-3 * med}
        self.left_out = sorted(set(first) - moved)
        grad_gap, self.worst_grad = worst_leaf(self.grad_norms, first)
        change_gap, self.worst_change = worst_leaf(self.change_norms, change, moved)
        return {"loss_gap": max(rel_gap(p, r) for p, r in zip(self.losses, losses)),
                "grad_gap": grad_gap, "change_gap": change_gap}

    def check(self, check):
        check.add("batches_off", self.batches_off())
        for name, value in self.gaps(self.reference_steps()).items():
            check.add(name, value)
        print(f"train check: worst leaves {self.worst_grad} (gradient), "
              f"{self.worst_change} (change); left out of the change "
              f"{self.left_out}", file=sys.stderr)
