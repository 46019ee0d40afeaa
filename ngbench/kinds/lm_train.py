"""Language-model training cells: the port's LM train step
(``api.build_train_step``) under its ``TrainEngine``, on batches of token
ids drawn on the device.

Set-up builds the model the configuration file describes
(``program_lm.model_config``: the port's arch at the file's depth and
held experts), draws its f32 weights on the card from the seed, keeps a
host copy of them for the check, and drives the engine's own ``run``: one
step, then two, then a whole chunk, before the window. After the first
step it reads each leaf's norm of Adam's first moment (the gradient the
optimizer got), after the third the norm of each leaf's change. The
window then runs whole chunks until its seconds are up. The steps'
metrics rows carry ``moe_dropped``, which the check counts as a number
that must be 0.

The check follows the same three steps with the plain reference (the
app's loss, ``apps/<app>.lm_train.py``) in f32 from the same weights and
batches, once the program's state is freed, in blocks of ``row_block``
rows: each step's loss, the first gradient's norm and the weights' change
after three steps, leaf by leaf, as ``kinds/train.py`` compares them.

Adding a language-model configuration: ``configs/<name>.json`` holds the
model's config.json keys, cut as its ``reduced`` says, with ``arch`` (the
port's registry name, whose kinds of layer it keeps), ``app`` (its
``apps/<app>.lm_train.py``: the reference's loss in row blocks, the
controls, the counted FLOPs from ``lm_counts.py``), ``experts_routed`` and
``first_expert_held`` (the device's share of an expert-parallel layer),
``published``, ``deployment`` and ``assumed``. ``program_lm.py`` is the
kind's one import of the port. The traffic is ``token_batches``
(``rows`` x ``seq_len`` ids a step, drawn on the card from the seed and
the step). ``control.py`` on such a cell prints the program's readings
and each of the app's ``CONTROLS``. A reader of a program phase the
tracer does not record by default asks for it when it is loaded
(``program_lm.record_phases``, as ``ssm_device_ms`` and ``moe_device_ms``
do).
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List, Optional

import torch

from ngbench import lm_counts, program_lm, spec
from ngbench.bench import log

CHECK_STEPS = 3


class LMTrainCell:
    """Set-up, window and check of one LM training cell."""

    def __init__(self, cell, seed: int, device: torch.device,
                 traffic_module, app):
        self.cell, self.dev, self.app = cell, device, app
        wl, self.config = cell.workload, cell.config
        self.train = wl["train"]
        self.model = program_lm.model_config(self.config, self.train)
        self.batch_of = traffic_module.make(cell.traffic, seed, device,
                                            self.config["vocab_size"])
        self.step_fn = program_lm.train_step(self.model, self.train)
        params = program_lm.init_params(self.model, seed, device, self.train)
        # the weights the reference starts from, on the host: the card
        # holds the program's state, then the reference's
        self.p0 = {k: v.detach().to("cpu", copy=True)
                   for k, v in program_lm.reference_leaves(params,
                                                           self.model)}
        self.state = program_lm.train_state(params)
        self.offset = 0                 # global step of a run's step 0
        self.host_spans: List = []
        self.rows: List[Dict] = []
        self.losses: List[float] = []
        self.engine = program_lm.train_engine(self.step_fn, self._batch,
                                              self.train["chunk_steps"],
                                              self.train["chunk_steps"])

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        self._mark("enqueue a step" if step < self._run_steps - 1
                   else "enqueue the chunk's last step, read its metrics")
        return self.batch_of(self.offset + step)

    def _mark(self, label: str) -> None:
        now = time.time_ns()
        if self.host_spans:
            last = self.host_spans[-1]
            self.host_spans[-1] = (last[0], last[1], now)
        self.host_spans.append((label, now, now + 1))

    def _run(self, engine, steps: int) -> List[Dict]:
        self._run_steps = steps
        self.state, hist = engine.run(self.state)
        self._mark("between chunks")
        self.offset += steps
        self.rows += hist
        return hist

    def _norms(self, tree) -> Dict[str, float]:
        return {k: float(v.float().norm()) for k, v in
                program_lm.reference_leaves(tree, self.model)}

    # --------------------------------------------------------------- set-up
    def warm(self) -> None:
        """Steps 1, 2-3 and a whole chunk through the engine; keeps the
        first gradient's and the three steps' change's norms and the first
        losses."""
        one = program_lm.train_engine(self.step_fn, self._batch, 1,
                                      self.train["chunk_steps"])
        two = program_lm.train_engine(self.step_fn, self._batch, 2,
                                      self.train["chunk_steps"])
        hist = self._run(one, 1)
        b1 = self.train["b1"]
        self.grad1 = {k: v / (1.0 - b1) for k, v in
                      self._norms(program_lm.adam_moment(self.state)).items()}
        hist += self._run(two, 2)
        self.update3 = {
            k: float((v.float() - self.p0[k].to(v.device)).norm())
            for k, v in program_lm.reference_leaves(
                program_lm.params_of(self.state), self.model)}
        self.first_losses = [row["loss"] for row in hist]
        self._run(self.engine, self.train["chunk_steps"])
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # --------------------------------------------------------------- window
    def window(self, seconds: float, trace=None) -> Dict:
        self.host_spans = []
        if trace is not None:
            trace.start()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        steps = 0
        rows: List[Dict] = []
        while time.perf_counter() < deadline:
            rows += self._run(self.engine, self.train["chunk_steps"])
            steps += self.train["chunk_steps"]
        t1 = time.perf_counter()
        if trace is not None:
            trace.stop()
        self.losses = [row["loss"] for row in rows]
        return {"steps": steps, "seconds": t1 - t0}

    def close(self) -> None:
        self.state = self.engine = None
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------- check
    def reference(self, switches: Optional[Dict] = None) -> Dict:
        """The reference's first CHECK_STEPS steps from the same weights
        and batches, with the control's ``switches``: losses, each leaf's
        first gradient's norm and its change's norm after the steps."""
        t = self.train
        switches = switches or {}
        params = {k: v.to(self.dev, copy=True).requires_grad_(True)
                  for k, v in self.p0.items()}
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v2 = {k: torch.zeros_like(v) for k, v in params.items()}
        losses, grad1 = [], None
        for step in range(1, CHECK_STEPS + 1):
            for p in params.values():
                p.grad = torch.zeros_like(p)    # a control's unused leaf: 0
            losses.append(self.app.step_loss_and_grads(
                params, self.config, self.batch_of(step - 1),
                self.cell.workload["check"]["row_block"], switches))
            if grad1 is None:
                grad1 = {k: float(p.grad.norm()) for k, p in params.items()}
            bc1 = float(1.0 - _f32(t["b1"]) ** _f32(step))
            bc2 = float(1.0 - _f32(t["b2"]) ** _f32(step))
            lr = float(_f32(t["lr"]))
            with torch.no_grad():
                for k, p in params.items():
                    g = p.grad
                    m[k].mul_(t["b1"]).add_(g, alpha=1.0 - t["b1"])
                    v2[k].mul_(t["b2"]).addcmul_(g, g, value=1.0 - t["b2"])
                    u = (m[k] / bc1) / ((v2[k] / bc2).sqrt() + t["eps"])
                    p.sub_(lr * u)
        update = {k: float((p.detach() - self.p0[k].to(self.dev)).norm())
                  for k, p in params.items()}
        del params, m, v2
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return {"losses": losses, "grad1": grad1, "update": update}

    @staticmethod
    def numbers(got_losses, got_grad1, got_update, want: Dict,
                leaves: bool = False) -> Dict[str, float]:
        """``kinds/train.py``'s numbers from leaf norms: each step's loss
        gap over the reference's loss; the worst leaf's gap of the first
        gradient's norm; the gap of the weights' change after the three
        steps at the median leaf and at the worst; each over the larger
        of that leaf's reference norm and the median leaf's. Leaves whose
        reference gradient is under a thousandth of the median leaf's are
        left out."""
        gn = want["grad1"]
        med_g = statistics.median(gn.values())
        keep = [k for k in gn if gn[k] >= 1e-3 * med_g]
        dn = {k: want["update"][k] for k in keep}
        med_d = statistics.median(dn.values())
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(got_losses, want["losses"]))
        grad_gap = max(abs(got_grad1[k] - gn[k]) / max(gn[k], med_g)
                       for k in keep)
        upd = {k: abs(got_update[k] - dn[k]) / max(dn[k], med_d)
               for k in keep}
        out = {"loss_gap": loss_gap, "grad_norm_gap": grad_gap,
               "update_norm_gap": statistics.median(upd.values()),
               "update_norm_gap_worst": max(upd.values())}
        if leaves:
            out["leaves"] = {k: [gn[k], dn[k], upd[k]] for k in keep}
        return out

    def check(self, switches: Optional[Dict] = None) -> Dict[str, float]:
        want = self.reference(switches)
        return self.numbers(self.first_losses, self.grad1, self.update3,
                            want)

    # -------------------------------------------------------------- outcome
    def dropped(self) -> float:
        """The assignments the program's MoE dropped, over every step run
        (set-up and window)."""
        return float(sum(row["moe_dropped"] for row in self.rows))

    def finish(self, win: Dict, trace: bool) -> Dict:
        """After the window: the program's state freed, the reference's
        check of the first steps, the end-to-end value and, traced, what
        the per-layer readers read."""
        steps = win["steps"]
        self.close()
        t0 = time.perf_counter()
        numbers = self.check()
        log(f"{self.cell.name}: reference {time.perf_counter() - t0:.1f} s")
        numbers["moe_max_load"] = max(row["moe_max_load"]
                                      for row in self.rows)
        run = {}
        if trace:
            mix = self.cell.traffic
            flops = self.app.step_flops(self.config, mix["rows"],
                                        mix["seq_len"])
            run = dict(units=steps, calls_per_unit={}, call_work={},
                       compute_s=steps * lm_counts.compute_time_s(flops))
        return {"values": {"train_step_ms": win["seconds"] / steps * 1e3},
                "attempted": steps,
                "failed": sum(1 for x in self.losses if not math.isfinite(x)),
                "must_be_0": {"moe_dropped": self.dropped()},
                "numbers": numbers, "run": run}

    def readings(self, seconds: float, control: bool):
        """The check's numbers of the first steps, for the program and,
        with ``control``, for each control (``app.CONTROLS``: the
        reference with one switch in the program's place). Needs no
        window. Yields (side, numbers, notes)."""
        self.warm()
        self.close()
        want = self.reference()
        notes = {"moe_dropped": self.dropped()}
        yield "program", self.numbers(self.first_losses, self.grad1,
                                      self.update3, want, leaves=True), notes
        if not control:
            return
        for side, switches in self.app.CONTROLS.items():
            ctl = self.reference(switches)
            yield side, self.numbers(ctl["losses"], ctl["grad1"],
                                     ctl["update"], want, leaves=True), {}


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def make(cell, seed: int, device: torch.device, program,
         here=spec.HERE) -> LMTrainCell:
    """``program`` (the field cells' module) is not used: the LM cells'
    program is ``program_lm``."""
    return LMTrainCell(cell, seed, device, spec.generator(cell, here),
                       spec.app(cell, here))
