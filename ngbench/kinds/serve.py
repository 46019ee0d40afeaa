"""Serving cells: viewers' frames through the program's ``RenderEngine``.

Each viewer of the mix keeps one frame in flight (a closed loop): its
frame is split into whole tiles of the engine's ``tile_pixels``, the
viewers' tiles are submitted in turn, and a viewer whose tiles are all
submitted waits for its last ``Ticket.result()`` and then issues its next
frame. A frame's latency runs from its issue to that return.

After the window a sample of frames drawn from the seed (kept as the
program returned them) is rendered again by the plain reference
(``ngbench/reference``, through the app's ``apps/<app>.serve.py``) from
the same weights, cameras and occupancy grid, and compared pixel by
pixel.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ngbench import counts, peaks, scenes, spec
from ngbench.bench import log
from ngbench.reference.field import Field, grid_of, mlp_of

# seconds the harness waits after the window for a sampled frame
LATE_S = 60.0


class _Viewer:
    def __init__(self, viewer, scene: str):
        self.v = viewer
        self.scene = scene
        self.frames = viewer.frames()
        self.k = -1
        self.tickets: List = []
        self.next_tile = 0

    def issue(self, program, now: float) -> None:
        self.k += 1
        self.position = next(self.frames)
        self.cam = self.v.camera(self.position)
        self.prog_cam = program.camera(self.cam)
        self.t_issue = now
        self.tickets, self.next_tile = [], 0


class ServeCell:
    """Set-up, window and check of one serving cell."""

    def __init__(self, cell, seed: int, device: torch.device, program,
                 traffic_module, app):
        self.cell, self.seed, self.dev, self.program, self.app = \
            cell, seed, device, program, app
        wl, cfg = cell.workload, cell.config
        self.engine_cfg = wl["engine"]
        self.cfg = cfg
        self.tp = self.engine_cfg["tile_pixels"]
        tr = cell.traffic
        self.h, self.w = tr["height"], tr["width"]
        n_pix = self.h * self.w
        if n_pix % self.tp:
            raise ValueError(f"{cell.name}: a {self.h}x{self.w} frame is not "
                             f"whole tiles of {self.tp}")
        self.tiles = [np.arange(s, s + self.tp, dtype=np.int64)
                      for s in range(0, n_pix, self.tp)]
        n_scenes = wl["scenes"]
        fcfg = program.field_config(cfg)
        occ = None
        if self.engine_cfg["occupancy"]:
            o = wl["occupancy"]
            occ = scenes.analytic_occupancy(o["res"], o["threshold"], device)
        self.params = []
        for s in range(n_scenes):
            p = scenes.make_weights(cfg, wl["weights"],
                                    scenes.generator(seed, s, device), device)
            if occ is not None:
                p = {**p, "occupancy": occ}
            self.params.append(p)
        self.engine = program.render_engine(self.engine_cfg, device)
        for s, p in enumerate(self.params):
            self.engine.add_scene(f"scene{s}", fcfg, p)
        self.viewers = [_Viewer(v, f"scene{v.index % n_scenes}")
                        for v in traffic_module.make(tr, seed)]
        chk = wl["check"]
        rng = np.random.default_rng([seed, 7])
        self.sampled = {(v.v.index, int(k)) for v in self.viewers
                        for k in rng.choice(chk["from_first"],
                                            chk["frames_per_viewer"],
                                            replace=False)}
        self.kept: Dict = {}
        self.dropped_in_reference = 0
        self.host_spans: List = []
        self.submit_s: List[float] = []
        self.order: List = []          # (viewer, frame, tile) submitted

    # --------------------------------------------------------------- set-up
    def warm(self) -> None:
        """The engine's padded warm-up tile, then one frame of viewer 0 at
        its start (outside the stream of frames)."""
        self.engine.warmup()
        v = self.viewers[0]
        cam = self.program.camera(v.v.camera(v.v.start))
        tickets = [self.engine.submit(self.program.request(v.scene, cam, ids))
                   for ids in self.tiles]
        for t in tickets:
            t.result()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # --------------------------------------------------------------- window
    def _step(self, turn: int, record: bool) -> Optional[tuple]:
        """One turn of the loop: a tile of this viewer, or its frame's end.
        Returns (viewer, frame, latency s, t_done) when a frame ended."""
        v = self.viewers[turn % len(self.viewers)]
        if v.next_tile < len(self.tiles):
            t0n, t0 = time.time_ns(), time.perf_counter()
            ticket = self.engine.submit(self.program.request(
                v.scene, v.prog_cam, self.tiles[v.next_tile]))
            t1 = time.perf_counter()
            v.tickets.append(ticket)
            if record:
                self.host_spans.append(("submit", t0n, time.time_ns()))
                self.submit_s.append(t1 - t0)
                self.order.append((v.v.index, v.k, v.next_tile))
            v.next_tile += 1
            return None
        t0n = time.time_ns()
        parts = [t.result() for t in v.tickets]
        t_done = time.perf_counter()
        if record:
            self.host_spans.append(("wait for frame", t0n, time.time_ns()))
        key = (v.v.index, v.k)
        if key in self.sampled:
            self.kept[key] = (v.cam, np.concatenate(parts))
        done = (v.v.index, v.k, t_done - v.t_issue, t_done)
        t1n = time.time_ns()
        v.issue(self.program, time.perf_counter())
        if record:
            self.host_spans.append(("issue frame", t1n, time.time_ns()))
        return done

    def window(self, seconds: float, trace=None) -> Dict:
        """Serve for ``seconds``; returns the window's frames and counts."""
        before = self.program.samples(self.engine)
        if trace is not None:
            trace.start()
        t_start = time.perf_counter()
        for v in self.viewers:
            v.issue(self.program, t_start)
        deadline = t_start + seconds
        frames = []
        turn = 0
        while time.perf_counter() < deadline:
            done = self._step(turn, True)
            turn += 1
            if done is not None and done[3] <= deadline:
                frames.append(done)
        n_tiles = len(self.order)
        if trace is not None:
            self.engine.flush()
            trace.stop()
        after = self.program.samples(self.engine)
        return {"frames": frames, "seconds": seconds, "tiles": n_tiles,
                "samples": tuple(a - b for a, b in zip(after, before))}

    def finish_sampled(self) -> int:
        """Serve on, outside the window, until every sampled frame came
        back (at most LATE_S); returns the sampled frames never served."""
        t_end = time.perf_counter() + LATE_S
        turn = 0
        while len(self.kept) < len(self.sampled) \
                and time.perf_counter() < t_end:
            self._step(turn, False)
            turn += 1
        self.engine.flush()
        return len(self.sampled) - len(self.kept)

    def close(self) -> None:
        """Free the program's state: its engine and its stacked scenes."""
        self.engine = None
        for v in self.viewers:
            v.tickets = []
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------- check
    def reference_frame(self, params: Dict, cam, precision: str,
                        points_seen=None) -> torch.Tensor:
        """The reference's (H*W, 3) pixels of one frame, tile by tile."""
        e = self.engine_cfg
        field = Field(self.cfg, params, precision)
        occ = params.get("occupancy")
        out = []
        for j, ids in enumerate(self.tiles):
            ids_t = torch.from_numpy(ids).to(self.dev)
            seen = None if points_seen is None else \
                (lambda x, j=j: points_seen(j, x))
            rgb, dropped = self.app.reference_tile(field, cam, ids_t, e, occ,
                                                   seen)
            self.dropped_in_reference += dropped
            out.append(rgb)
        return torch.cat(out)

    def check(self, precision: str = "f32", count_rows: bool = False,
              frames: Optional[Dict] = None) -> Dict:
        """Per-pixel errors of the kept frames (or ``frames``: {key: (cam,
        pixels)}) against the reference; with ``count_rows``, the distinct
        table rows of each field call of those frames' tiles."""
        frames = self.kept if frames is None else frames
        self.dropped_in_reference = 0
        errs, rows = [], {}
        g = grid_of(self.cfg)
        for key in sorted(frames):
            cam, pixels = frames[key]
            params = self.params[key[0] % len(self.params)]
            calls: Dict[int, List[int]] = {}

            def seen(j, x):
                calls.setdefault(j, []).append(
                    (x.shape[0], counts.distinct_rows(x, g)))
            with torch.no_grad():
                want = self.reference_frame(params, cam, precision,
                                            seen if count_rows else None)
            got = torch.from_numpy(np.ascontiguousarray(pixels)).to(self.dev)
            errs.append((got - want).abs().amax(dim=-1))
            if count_rows:
                rows[key] = calls
        err = torch.cat(errs) if errs else torch.zeros(0)
        return {"err": err, "rows": rows,
                "dropped": self.dropped_in_reference}

    def numbers(self, err: torch.Tensor) -> Dict[str, float]:
        """The compared numbers of per-pixel errors (the largest channel's
        error of each pixel): their largest, and their 99.9th percentile,
        which a few pixels on a silhouette that one side's sphere trace
        hits and the other's misses do not move."""
        if err.numel() == 0:
            return {}
        k = max(1, int(round(0.999 * err.numel())))
        return {"px_err_max": float(err.max()),
                "px_err_p999": float(err.float().kthvalue(k).values)}

    # ---------------------------------------------------------------- counts
    def call_work(self, rows: Dict) -> Dict[str, Dict[int, dict]]:
        """Work of the port's kernel calls, by the call's index among the
        window's calls of that kernel: ``field_fwd`` for the sampled
        frames' tiles (their counted rows), the app's other kernels for
        every tile."""
        per_tile = self.app.calls_per_tile(self.engine_cfg)
        pos = {key: i for i, key in enumerate(self.order)}
        g, head = grid_of(self.cfg), mlp_of(self.cfg, self.app.HEAD)
        out: Dict[str, Dict[int, dict]] = {"field_fwd": {}}
        for (vi, k), calls in rows.items():
            for j, rows_j in calls.items():
                i = pos.get((vi, k, j))
                if i is None:
                    continue
                for c, (n, r) in enumerate(rows_j):
                    out["field_fwd"][i * per_tile["field_fwd"] + c] = \
                        counts.field_fwd(n, g, head, r)
        for kernel, w in self.app.tile_work(self.cfg,
                                            self.engine_cfg).items():
            out[kernel] = {i: w for i in range(len(self.order))}
        return out

    # -------------------------------------------------------------- outcome
    def finish(self, win: Dict, trace: bool) -> Dict:
        """After the window: the sampled frames served out, the program's
        state freed, the reference's check, the end-to-end values and,
        traced, what the per-layer readers read."""
        frames = win["frames"]
        values = {}
        if frames:
            values["mpix_per_s"] = (len(frames) * self.h * self.w
                                    / win["seconds"] / 1e6)
            values["frame_p95_ms"] = p95([f[2] for f in frames]) * 1e3
        live, total, dropped = win["samples"]
        occupancy = self.engine_cfg["occupancy"]
        must_be_0 = {"frames_never_served": self.finish_sampled()}
        if occupancy:
            must_be_0["samples_dropped"] = float(dropped)
        log(f"{self.cell.name}: {len(frames)} frames in the window, "
            f"{len(self.kept)} kept for the check")
        self.close()
        t0 = time.perf_counter()
        got = self.check("f32", count_rows=trace)
        log(f"{self.cell.name}: reference {time.perf_counter() - t0:.1f} s "
            f"over {len(self.kept)} frames")
        run = {}
        if trace:
            n_tiles = win["tiles"]
            live_tile = live / n_tiles if occupancy and n_tiles else None
            run = dict(
                tiles=n_tiles, tiles_per_frame=len(self.tiles),
                calls_per_unit=self.app.calls_per_tile(self.engine_cfg),
                units=n_tiles, call_work=self.call_work(got["rows"]),
                submit_s=self.submit_s, samples=win["samples"],
                compute_s=n_tiles * peaks.compute_time_s(
                    self.app.tile_compute(self.cfg, self.engine_cfg,
                                          live_tile)))
        return {"values": values, "attempted": len(frames),
                "failed": len(frames) if dropped > 0 else 0,
                "must_be_0": must_be_0,
                "numbers": self.numbers(got["err"]), "run": run}

    def readings(self, seconds: float, control: bool):
        """The check's numbers after a short window, for the program and,
        with ``control``, for the control: the reference with TF32
        products in the program's place. Yields (side, numbers, notes)."""
        self.warm()
        win = self.window(seconds)
        missing = self.finish_sampled()
        self.close()
        yield "program", self.numbers(self.check("f32")["err"]), \
            {"frames": len(win["frames"]), "missing": missing}
        if control:
            with torch.no_grad():
                frames = {k: (cam, self.reference_frame(
                    self.params[k[0] % len(self.params)], cam, "tf32"
                ).cpu().numpy()) for k, (cam, _) in self.kept.items()}
            yield "control_tf32", \
                self.numbers(self.check("f32", frames=frames)["err"]), {}


def p95(values: List[float]) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def make(cell, seed: int, device: torch.device, program,
         here=spec.HERE) -> ServeCell:
    return ServeCell(cell, seed, device, program,
                     spec.generator(cell, here), spec.app(cell, here))
