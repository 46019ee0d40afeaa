"""Training cells: the program's ``TrainEngine`` on a pool of ray batches.

Set-up builds one training state (the weights drawn from the seed, Adam's
moments) and one step function, and drives them through the engine's own
``run`` on the pool: one step, then two, then a whole chunk, before the
window. After the first step the harness reads Adam's first moment (the
gradient as the optimizer got it), after the third the weights. The window
then runs whole chunks of the same engine, step function, feed and state
until its seconds are up.

The check follows the same three steps with the plain reference (the
app's loss, ``apps/<app>.train.py``) from the same weights and batches:
each step's loss, the first gradient's norm and the change of the weights
after three steps, leaf by leaf.
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List

import torch

from ngbench import counts, peaks, scenes, spec
from ngbench.bench import log
from ngbench.reference.field import Field, grid_of, mlp_of

CHECK_STEPS = 3


def tree_items(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


class TrainCell:
    """Set-up, window and check of one training cell."""

    def __init__(self, cell, seed: int, device: torch.device, program,
                 traffic_module, app):
        self.cell, self.seed, self.dev, self.program, self.app = \
            cell, seed, device, program, app
        wl, self.cfg = cell.workload, cell.config
        self.train = wl["train"]
        self.pool = traffic_module.make(cell.traffic, seed, device)
        self.p0 = scenes.make_weights(self.cfg, wl["weights"],
                                      scenes.generator(seed, 0, device),
                                      device)
        self.step_fn = program.train_step(self.cfg, self.train)
        self.state = program.train_state(scenes.clone_tree(self.p0))
        self.offset = 0                 # global step of a run's step 0
        self.host_spans: List = []
        self.losses: List[float] = []
        self.engine = program.train_engine(self.step_fn, self._batch,
                                           self.train["chunk_steps"],
                                           self.train["chunk_steps"])

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        i = self.offset + step
        self._mark("enqueue a step" if step < self._run_steps - 1
                   else "enqueue the chunk's last step, read its metrics")
        return self.pool[i % len(self.pool)]

    def _mark(self, label: str) -> None:
        now = time.time_ns()
        if self.host_spans:
            last = self.host_spans[-1]
            self.host_spans[-1] = (last[0], last[1], now)
        self.host_spans.append((label, now, now + 1))

    def _run(self, engine, steps: int):
        self._run_steps = steps
        self.state, hist = engine.run(self.state)
        self._mark("between chunks")
        self.offset += steps
        return [row["loss"] for row in hist]

    # --------------------------------------------------------------- set-up
    def warm(self) -> None:
        """Steps 1, 2-3 and a whole chunk through the engine; keeps the
        first gradient, the weights after step 3 and the first losses."""
        one = self.program.train_engine(self.step_fn, self._batch, 1,
                                        self.train["chunk_steps"])
        two = self.program.train_engine(self.step_fn, self._batch, 2,
                                        self.train["chunk_steps"])
        losses = self._run(one, 1)
        b1 = self.train["b1"]
        self.grad1 = {k: v.detach().clone() / (1.0 - b1) for k, v in
                      tree_items(self.program.adam_moment(self.state))}
        losses += self._run(two, 2)
        self.params3 = {k: v.detach().clone() for k, v in
                        tree_items(self.program.params_of(self.state))}
        self.first_losses = losses
        self._run(self.engine, self.train["chunk_steps"])
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # --------------------------------------------------------------- window
    def window(self, seconds: float, trace=None) -> Dict:
        self.host_spans = []
        self.window_offset = self.offset
        if trace is not None:
            trace.start()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        steps = 0
        losses = []
        while time.perf_counter() < deadline:
            losses += self._run(self.engine, self.train["chunk_steps"])
            steps += self.train["chunk_steps"]
        t1 = time.perf_counter()
        if trace is not None:
            trace.stop()
        self.losses = losses
        return {"steps": steps, "seconds": t1 - t0}

    def close(self) -> None:
        self.state = self.engine = None
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------- check
    def reference(self, precision: str = "f32", batch_rows=None) -> Dict:
        """The reference's first CHECK_STEPS steps from the same weights
        and batches: losses, the first gradient, the weights after.
        ``batch_rows(batch)`` may cut a batch (a planted fault)."""
        t = self.train
        params = {k: v.detach().clone() for k, v in tree_items(self.p0)}
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v2 = {k: torch.zeros_like(v) for k, v in params.items()}
        losses, grad1 = [], None
        for step in range(1, CHECK_STEPS + 1):
            batch = self.pool[step - 1]
            if batch_rows is not None:
                batch = batch_rows(batch)
            leaves = {k: p.detach().requires_grad_(True)
                      for k, p in params.items()}
            field = Field(self.cfg, _untree(leaves), precision)
            loss = self.app.loss(field, batch, t)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            grads = dict(zip(leaves, grads))
            losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = {k: g.detach().clone() for k, g in grads.items()}
            bc1 = float(1.0 - f32(t["b1"]) ** f32(step))
            bc2 = float(1.0 - f32(t["b2"]) ** f32(step))
            lr = float(f32(t["lr"]))
            with torch.no_grad():
                for k, g in grads.items():
                    m[k].mul_(t["b1"]).add_(g, alpha=1.0 - t["b1"])
                    v2[k].mul_(t["b2"]).addcmul_(g, g, value=1.0 - t["b2"])
                    u = (m[k] / bc1) / ((v2[k] / bc2).sqrt() + t["eps"])
                    params[k] = params[k] - lr * u
        return {"losses": losses, "grad1": grad1, "params": params}

    def numbers(self, got_losses, got_grad1, got_params, want: Dict,
                leaves: bool = False) -> Dict[str, float]:
        """Each step's loss gap over the reference's loss; the worst leaf's
        gap of the first gradient's norm; the gap of the weights' change
        after the three steps at the median leaf and at the worst; each
        over the larger of that leaf's reference norm and the median
        leaf's. The worst leaf's change swings by an order from seed to
        seed (a density-MLP leaf whose first gradients sit a few orders
        above Adam's eps), so the median leaf's is held beside it
        (PERF.md). Leaves whose reference gradient is under a thousandth
        of the median leaf's (moved by round-off alone) are left out."""
        p0 = dict(tree_items(self.p0))
        gn = {k: float(g.norm()) for k, g in want["grad1"].items()}
        med_g = statistics.median(gn.values())
        keep = [k for k in gn if gn[k] >= 1e-3 * med_g]
        dn = {k: float((want["params"][k] - p0[k]).norm()) for k in keep}
        med_d = statistics.median(dn.values())
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(got_losses, want["losses"]))
        grad_gap = max(abs(float(got_grad1[k].norm()) - gn[k])
                       / max(gn[k], med_g) for k in keep)
        upd = {k: abs(float((got_params[k] - p0[k]).norm()) - dn[k])
               / max(dn[k], med_d) for k in keep}
        out = {"loss_gap": loss_gap, "grad_norm_gap": grad_gap,
               "update_norm_gap": statistics.median(upd.values()),
               "update_norm_gap_worst": max(upd.values())}
        if leaves:
            out["leaves"] = {k: [gn[k], dn[k], upd[k]] for k in keep}
        return out

    def check(self, precision: str = "f32") -> Dict[str, float]:
        want = self.reference(precision)
        return self.numbers(self.first_losses, self.grad1, self.params3, want)

    # ---------------------------------------------------------------- counts
    def call_work(self, steps: int) -> Dict[str, Dict[int, dict]]:
        """Work of each ``field_fwd`` and ``encode_bwd`` call of the window
        (one of each a step), the table rows counted for each batch."""
        g = grid_of(self.cfg)
        head = mlp_of(self.cfg, self.app.HEAD)
        rows = {}
        for k, batch in enumerate(self.pool):
            with torch.no_grad():
                rows[k] = counts.distinct_rows(
                    self.app.points(batch, self.train), g)
        n = self.pool[0]["origins"].shape[0] * self.train["n_samples"]
        field, bwd = {}, {}
        for k in range(steps):
            i = (self.window_offset + k) % len(self.pool)
            field[k] = counts.field_fwd(n, g, head, rows[i])
            bwd[k] = counts.encode_bwd(n, g)
        return {"field_fwd": field, "encode_bwd": bwd}

    # -------------------------------------------------------------- outcome
    def finish(self, win: Dict, trace: bool) -> Dict:
        """After the window: the program's state freed, the reference's
        check of the first steps, the end-to-end value and, traced, what
        the per-layer readers read."""
        steps = win["steps"]
        self.close()
        t0 = time.perf_counter()
        numbers = self.check("f32")
        log(f"{self.cell.name}: reference {time.perf_counter() - t0:.1f} s")
        run = {}
        if trace:
            step = self.app.step_compute(
                self.cfg, self.train, self.pool[0]["origins"].shape[0],
                counts.n_params(self.p0))
            run = dict(units=steps,
                       calls_per_unit={"field_fwd": 1, "encode_bwd": 1},
                       call_work=self.call_work(steps),
                       compute_s=steps * peaks.compute_time_s(step))
        return {"values": {"train_step_ms": win["seconds"] / steps * 1e3},
                "attempted": steps,
                "failed": sum(1 for x in self.losses if not math.isfinite(x)),
                "must_be_0": {}, "numbers": numbers, "run": run}

    def readings(self, seconds: float, control: bool):
        """The check's numbers of the first steps, for the program and,
        with ``control``, for the control (the reference with TF32
        products in the program's place) and for the planted fault of half
        of each batch's rays left out, the loss their mean. Needs no
        window. Yields (side, numbers, notes)."""
        self.warm()
        self.close()
        want = self.reference("f32")
        yield "program", self.numbers(self.first_losses, self.grad1,
                                      self.params3, want, leaves=True), {}
        if not control:
            return
        ctl = self.reference("tf32")
        yield "control_tf32", self.numbers(ctl["losses"], ctl["grad1"],
                                           ctl["params"], want,
                                           leaves=True), {}

        def half(batch):
            n = batch["origins"].shape[0] // 2
            return {k: v[:n] for k, v in batch.items()}
        flt = self.reference("f32", batch_rows=half)
        yield "fault_half_batch", self.numbers(flt["losses"], flt["grad1"],
                                               flt["params"], want), {}


def make(cell, seed: int, device: torch.device, program,
         here=spec.HERE) -> TrainCell:
    return TrainCell(cell, seed, device, program,
                     spec.generator(cell, here), spec.app(cell, here))


def _untree(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out
