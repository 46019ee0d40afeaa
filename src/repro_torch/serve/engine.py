"""RenderEngine: batched multi-scene serving on one device.

  * **Shape buckets.** Requests are grouped by ``(app, encoding,
    tile_pixels, n_samples, dtype, cfg, occupancy, sample_budget)``; scenes
    of one bucket share one tile function and one stack of parameters.
  * **Megabatch pad + mask.** Every request is padded to the bucket's fixed
    ``tile_pixels``; a mask zeroes the pad lanes and the host slices the
    valid prefix off the result.
  * **Stacked scenes.** Per-scene params are stacked along a leading scene
    axis; a request selects its scene as a view (no copy).
  * **Asynchronous dispatch.** ``submit`` enqueues the tile's kernels and
    the copy of its result into pinned host memory, records a CUDA event
    after them and returns a :class:`Ticket` without waiting for the
    device. It blocks only while more than ``max_inflight`` megabatches are
    outstanding. ``Ticket.result`` is the one sync point.
  * **Occupancy-culled sampling.** With ``settings.occupancy`` the ray
    apps march culled (``core/occupancy.py``): their scenes carry an
    ``occupancy`` grid (stacked like the tables), the bucket key adds
    ``(occupancy, sample_budget)``, each request's ``[n_live, n_total,
    n_dropped]`` sample counts over its valid pixels come to pinned host
    memory with its pixels, under the same event, and ``stats()`` reports
    the live-sample fraction and the dropped samples.
  * **Observability.** The engine owns a metrics ``Registry``: per-bucket
    ``submit``/``dispatch``/``block``/``slice`` phase histograms and the
    submit-to-retire latency histogram that ``stats()``'s p50/p99 read
    (warmup excluded).

Register all scenes, then ``warmup()`` (loads the kernels and warms the
allocators, outside the latency statistics), then submit requests.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import fields, pipeline, render
from repro_torch.core.fields import FieldConfig
from repro_torch.core.pipeline import RenderSettings
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.quant.api import is_quantized_field


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """Everything that selects a distinct tile function and scene stack.
    ``dtype`` is the ordered tuple of param-leaf dtypes: scenes of mixed
    precision must not stack with all-f32 ones."""
    app: str
    encoding: str
    tile_pixels: int
    n_samples: int
    dtype: str
    cfg: FieldConfig
    # the compaction's budget changes the work: budgets never share
    occupancy: bool = False
    sample_budget: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class RenderRequest:
    """One pixel-batch request: scene + viewpoint + flat pixel ids (at
    most ``tile_pixels`` of them; ``RenderEngine.render_frame`` splits a
    full frame into requests)."""
    scene: str
    camera: render.Camera
    pixel_ids: np.ndarray


def _leaves(tree) -> List[torch.Tensor]:
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the device tensor ``t``, queued on the current
    stream: nothing waits for it here."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
        t, non_blocking=True)


class Ticket:
    """Handle for an in-flight request; ``result()`` waits for it and
    returns the valid (n, 3) rgb rows as numpy.

    Recorded latency is submit to retire (it includes queueing behind
    earlier megabatches). The engine retires device-ready tickets on every
    later ``submit``, so a ticket held by the caller does not keep accruing
    host time."""

    def __init__(self, engine: "RenderEngine", host_out: torch.Tensor,
                 event: Optional[torch.cuda.Event], n_valid: int,
                 t_submit: float, warmup: bool, bucket_idx: int = 0,
                 host_aux: Optional[torch.Tensor] = None):
        self._engine = engine
        self._host_out = host_out          # filled once `event` completes
        self._host_aux = host_aux          # (1, 3) sample counts, likewise
        self._event = event                # None on the CPU: already done
        self._n = n_valid
        self._t_submit = t_submit
        self._warmup = warmup
        self._bidx = bucket_idx
        self._res: Optional[np.ndarray] = None
        self._done = False

    def is_ready(self) -> bool:
        return self._done or self._event is None or self._event.query()

    # repro: sync-boundary result() is THE designated submit/result sync point
    def result(self) -> np.ndarray:
        if not self._done:
            t_block0 = time.perf_counter()
            if self._event is not None:
                self._event.synchronize()
            t_done = time.perf_counter()
            self.latency_s = t_done - self._t_submit
            res = self._host_out.numpy()[:self._n]
            t_slice = time.perf_counter()
            if not self._warmup:
                self._engine._record(self.latency_s, self._n, t_done)
                self._engine._record_phase(self._bidx, "block",
                                           t_block0, t_done)
                self._engine._record_phase(self._bidx, "slice",
                                           t_done, t_slice)
                if self._host_aux is not None:
                    self._engine._record_aux(self._host_aux.numpy()[0])
            self._res = res
            self._done = True
        return self._res


class _Bucket:
    def __init__(self, cfg: FieldConfig, key: BucketKey, idx: int):
        self.cfg = cfg
        self.key = key
        self.idx = idx                       # insertion index (metric label)
        self.order: List[str] = []           # scene names, stack order
        self.params: Dict[str, dict] = {}
        self.stacked = None                  # cached stack of params
        self.fn = None                       # cached tile function


class RenderEngine:
    """Shape-bucketed, multi-scene, asynchronous render server on one
    device (CUDA unless the caller names another)."""

    def __init__(self, settings: Optional[RenderSettings] = None,
                 max_inflight: int = 2, device: DeviceLike = None):
        self.settings = settings or RenderSettings()
        self.device = resolve_device(device)
        self.max_inflight = max(1, max_inflight)
        # per-engine registry: engines in one process must not mix
        # latency histograms
        self.obs = obs_metrics.Registry()
        self._lat_hist = self.obs.histogram("serve.latency_s")
        self._buckets: Dict[BucketKey, _Bucket] = {}
        self._scene_bucket: Dict[str, BucketKey] = {}
        self._inflight: collections.deque = collections.deque()
        self._lat: List[float] = []          # exact latencies
        self._pixels = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._warmup_s = 0.0
        # culled sampling: [live, total, dropped] samples over the stream
        self._samples = np.zeros(3, np.float64)

    # ------------------------------------------------------------- scenes
    def add_scene(self, name: str, cfg: FieldConfig, params) -> BucketKey:
        """Register a scene; its params move to the engine's device.
        Scenes stack iff their FieldConfig (``quant`` included) and param
        dtypes match exactly; otherwise they get their own bucket. A
        quantized scene's params and config must agree both ways."""
        if name in self._scene_bucket:
            raise ValueError(f"scene {name!r} already registered")
        if cfg.app not in pipeline.APPS:
            raise ValueError(f"scene {name!r}: unknown app {cfg.app!r} "
                             f"(apps: {pipeline.APPS})")
        if is_quantized_field(params) and cfg.quant is None:
            raise ValueError(
                f"scene {name!r} has quantized params but cfg.quant is "
                "None: pair quantize_field(params, spec) with "
                "cfg.with_quant(spec)")
        if cfg.quant is not None and cfg.quant.table_qtype is not None \
                and "grid_scale" not in params:
            raise ValueError(
                f"scene {name!r}: cfg.quant declares table_qtype="
                f"{cfg.quant.table_qtype!r} but params have no "
                "'grid_scale' leaf: run repro_torch.quant.quantize_field")
        if (self.settings.occupancy and cfg.app in ("nerf", "nvr")
                and "occupancy" not in params):
            raise ValueError(
                f"engine settings have occupancy=True but scene {name!r} "
                "has no 'occupancy' leaf: build one with "
                "core.occupancy.build_occupancy and attach()")
        params = fields.to_device(params, self.device)
        dtype = ",".join(str(l.dtype) for l in _leaves(params))
        key = BucketKey(app=cfg.app, encoding=cfg.grid.kind,
                        tile_pixels=self.settings.tile_pixels,
                        n_samples=self.settings.n_samples, dtype=dtype,
                        cfg=cfg, occupancy=self.settings.occupancy,
                        sample_budget=self.settings.sample_budget)
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = self._buckets[key] = _Bucket(cfg, key,
                                                  len(self._buckets))
        bucket.order.append(name)
        bucket.params[name] = params
        bucket.stacked = None                # re-stack lazily
        self._scene_bucket[name] = key
        return key

    def scenes(self) -> List[str]:
        return list(self._scene_bucket)

    def _get_stacked(self, key: BucketKey):
        bucket = self._buckets[key]
        if bucket.stacked is None:
            bucket.stacked = pipeline.stack_scene_params(
                [bucket.params[n] for n in bucket.order])
            bucket.params = {n: pipeline.select_scene(bucket.stacked, i)
                             for i, n in enumerate(bucket.order)}
        return bucket.stacked

    def _get_fn(self, key: BucketKey):
        bucket = self._buckets[key]
        if bucket.fn is None:
            with_aux = self.settings.occupancy
            mtile = pipeline.make_multi_scene_tile_fn(
                bucket.cfg, self.settings, with_aux=with_aux)

            def fn(stacked, scene_id, cam, pixel_ids, mask, n_valid):
                out = mtile(stacked, scene_id, cam, pixel_ids, n_valid)
                rgb, aux = out if with_aux else (out, None)
                return torch.where(mask[:, None], rgb, 0.0), aux
            bucket.fn = fn
        return bucket.fn

    def warmup(self) -> float:
        """One dummy request per bucket (loads the kernel library, warms
        the allocators), excluded from the latency statistics."""
        t0 = time.perf_counter()
        cam = render.Camera(height=8, width=8, focal=8.0,
                            c2w=render.look_at((2.2, 1.6, 1.8), (0, 0, 0)))
        for bucket in self._buckets.values():
            req = RenderRequest(scene=bucket.order[0], camera=cam,
                                pixel_ids=np.zeros(1, np.int64))
            self.submit(req, _warmup=True).result()
        self._warmup_s += time.perf_counter() - t0
        return self._warmup_s

    # ------------------------------------------------------------- serve
    # repro: hot-path submit must stay async — device syncs live in result()
    def submit(self, req: RenderRequest, _warmup: bool = False) -> Ticket:
        key = self._scene_bucket.get(req.scene)
        if key is None:
            raise KeyError(f"unknown scene {req.scene!r}")
        bucket = self._buckets[key]
        tp = self.settings.tile_pixels
        t_prep0 = time.perf_counter()
        # repro: allow[host-sync] request ids arrive as host numpy
        ids = np.asarray(req.pixel_ids, np.int64).ravel()
        n = ids.shape[0]
        if n > tp:
            raise ValueError(f"request has {n} pixels > tile_pixels={tp}; "
                             "split it (see render_frame)")
        padded = torch.zeros(tp, dtype=torch.int64)
        padded[:n] = torch.from_numpy(ids)
        cuda = self.device.type == "cuda"
        if cuda:          # pinned, so the copy below is truly asynchronous
            padded = padded.pin_memory()

        fn = self._get_fn(key)
        stacked = self._get_stacked(key)
        sid = bucket.order.index(req.scene)
        t0 = time.perf_counter()
        if not _warmup and self._t_first is None:
            self._t_first = t0
        ids_dev = padded.to(self.device, non_blocking=True)
        mask = torch.arange(tp, device=self.device) < n
        rgb, aux = fn(stacked, sid, req.camera, ids_dev, mask, n)
        event = None
        if cuda:
            host_out = _pinned_copy(rgb)
            host_aux = None if aux is None else _pinned_copy(aux)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        else:
            host_out, host_aux = rgb, aux
        t_dispatched = time.perf_counter()
        if not _warmup:
            # host-side phase timings only: nothing here waits on the device
            self._record_phase(bucket.idx, "submit", t_prep0, t0)
            self._record_phase(bucket.idx, "dispatch", t0, t_dispatched)
        ticket = Ticket(self, host_out, event, n, t0, warmup=_warmup,
                        bucket_idx=bucket.idx, host_aux=host_aux)
        self._inflight.append(ticket)
        # retire already-finished work first so its recorded latency is
        # the device completion, not however long the caller sat on it
        while self._inflight and self._inflight[0].is_ready():
            self._inflight.popleft().result()
        # keep at most max_inflight megabatches queued: request N+1 is
        # enqueued above *before* this waits on N-k
        while len(self._inflight) > self.max_inflight:
            self._inflight.popleft().result()
        return ticket

    def flush(self):
        while self._inflight:
            self._inflight.popleft().result()

    def render_frame(self, scene: str, cam: render.Camera) -> np.ndarray:
        """Full-frame convenience: split into megabatch tiles, serve them
        through the queue, reassemble (H, W, 3)."""
        h, w = cam.resolution
        tp = self.settings.tile_pixels
        tickets = [self.submit(RenderRequest(
            scene, cam, np.arange(start, min(start + tp, h * w))))
            for start in range(0, h * w, tp)]
        parts = [t.result() for t in tickets]
        return np.concatenate(parts, axis=0).reshape(h, w, 3)

    # ------------------------------------------------------------- stats
    def _record(self, latency_s: float, n_pixels: int, t_done: float):
        self._lat.append(latency_s)
        self._lat_hist.record(latency_s)
        self.obs.counter("serve.requests").inc()
        self.obs.counter("serve.pixels").inc(n_pixels)
        self._pixels += n_pixels
        self._t_last = t_done

    def _record_phase(self, bucket_idx: int, phase: str,
                      t0: float, t1: float):
        self.obs.histogram(
            f"serve.{phase}_s.bucket{bucket_idx}").record(t1 - t0)

    def _record_aux(self, row: np.ndarray):
        self._samples += row

    def exact_percentiles(self, *ps: float) -> List[float]:
        """Exact order-statistic latencies (seconds): the oracle the
        histogram-derived p50/p99 in ``stats()`` are tested against."""
        lat = sorted(self._lat)

        def pct(p):
            if not lat:
                return float("nan")
            return lat[min(len(lat) - 1, int(round(p / 100.0
                                                   * (len(lat) - 1))))]
        return [pct(p) for p in ps]

    def stats(self) -> Dict:
        p50_s = self._lat_hist.percentile(50)
        p99_s = self._lat_hist.percentile(99)
        wall = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else 0.0)
        n_req = len(self._lat)
        live, total, dropped = self._samples
        # effective Mpix/s is the served rate: culling serves more pixels
        # in the same wall time; live_sample_frac says where it came from
        mpix = (self._pixels / wall / 1e6) if wall > 0 else float("nan")
        return {
            "device": str(self.device),
            "n_requests": n_req,
            "p50_ms": p50_s * 1e3,
            "p99_ms": p99_s * 1e3,
            "mpix_per_s": mpix,
            "effective_mpix_per_s": mpix,
            "live_sample_frac": (live / total) if total > 0
            else float("nan"),
            "samples_total": total,
            "samples_dropped": dropped,
            "requests_per_s": (n_req / wall) if wall > 0 else float("nan"),
            "wall_s": wall,
            "pixels": self._pixels,
            "warmup_s": self._warmup_s,
            "buckets": {
                f"{k.app}/{k.encoding}/tp{k.tile_pixels}/s{k.n_samples}"
                f"/{k.dtype}/T{k.cfg.grid.log2_table_size}"
                f"L{k.cfg.grid.n_levels}"
                + (f"/occ-bgt{k.sample_budget}" if k.occupancy else "")
                + (f"/q-{k.cfg.quant.tag}" if k.cfg.quant else "")
                + f"#{b.idx}": {"n_scenes": len(b.order)}
                for k, b in self._buckets.items()},
            "metrics": self.obs.snapshot(),
        }
