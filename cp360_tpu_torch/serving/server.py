"""HTTP saliency-inference server (stdlib-only, threaded).

The port of ``cp360_tpu/serving/server.py``: a long-lived process holding
the stage-1 model (and optionally the ConvLSTM) on the device, answering

    GET  /healthz                    -> {"status": "ok", ...}
    GET  /metrics                    -> Prometheus text
    POST /saliency                   -> image bytes (JPEG/PNG equi frame) in,
                                        JSON {"saliency": [...], "shape": [h, w]} out
    POST /saliency?format=png        -> grayscale PNG heatmap out
    POST /temporal/session           -> {"session": id}  (needs a ConvLSTM)
    POST /temporal/frame?session=ID  -> image bytes in; {"pending": k} until
                                        seq_len frames are buffered, then
                                        {"frame": i, "shape", "saliency"}
    POST /temporal/close?session=ID  -> {"closed": true}

Temporal sessions stream the stage-2 model statefully: the session state is
the rolling window of the last seq_len stage-1 CAM cubes (float16, on the
device).  Each new frame re-runs the published window protocol (joint
min/max normalization + ConvLSTM state seeded from the window's first
frame, temporal_model/test_temporal.py:66-79) over that window, so a
streaming client sees exactly the offline pipeline's predictions, one frame
of latency at a time.

Concurrent requests are coalesced by two dynamic batchers
(serving/batcher.py): host prep (decode, resize, optional host cube remap)
runs on the HTTP handler threads, then each batcher's worker groups up to
``serve_max_batch`` pending requests into ONE device step, padded to a
power-of-two bucket.  Stage-1 frames and temporal window inferences batch
independently; pushes within one session serialize on a per-session lock
(protocol order).

Stage 1 runs in one of two forms, chosen by ``host_cube_remap`` as the JAX
package's extraction does: ``false`` ships the u8 equirectangular frame and
runs ``pipelines/extract.py::stage1_batch`` (the equi->cube kernel on the
device); ``true`` samples the faces on the host with cv2 and runs
``stage1_batch_faces``, or with ``upload_format: yuv420`` packs them as
4:2:0 planes (half the bytes) for ``stage1_batch_faces_yuv``.

With ``mesh_data`` N > 1 the model serves data-parallel from a
``parallel/mesh.py::LocalReplicas`` over the first N local cards: every
device batch is a multiple of N (its buckets and cap rounded as the JAX
server rounds them) and splits into N row blocks, one per card.
Predictions are those of one card; ``/healthz`` and ``/metrics`` report
the data-parallel width.

Channel order passes through unchanged: the offline pipeline feeds cv2's
BGR bytes labeled RGB (a reference quirk), so bit-parity with offline
artifacts needs the client to send frames in that byte order.
"""

from __future__ import annotations

import io
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from cp360_tpu_torch.config import Config

MAX_SESSIONS = 64
SESSION_IDLE_TTL_S = 600.0  # abandoned sessions are evicted after this


def resolve_device(device) -> torch.device:
    """The entry points' device: CUDA unless the caller asks for the CPU.
    A CUDA device without a card raises; nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device}")
    return device


class RequestMetrics:
    """Thread-safe request counters/latency for the /metrics endpoint."""

    def __init__(self):
        self._lock = threading.Lock()
        self._requests: dict = {}  # (route, code) -> count
        self._latency: dict = {}  # route -> [sum_s, count]
        self.started = time.time()

    def observe(self, route: str, code: int, dur_s: float) -> None:
        with self._lock:
            key = (route, code)
            self._requests[key] = self._requests.get(key, 0) + 1
            s = self._latency.setdefault(route, [0.0, 0])
            s[0] += dur_s
            s[1] += 1

    def render(self, model: "SaliencyModel") -> str:
        """Prometheus text exposition (counters + live gauges)."""
        with self._lock:
            reqs = dict(self._requests)
            lat = {r: tuple(v) for r, v in self._latency.items()}
        lines = [
            "# TYPE cp360_requests_total counter",
            *(f'cp360_requests_total{{route="{r}",code="{c}"}} {n}'
              for (r, c), n in sorted(reqs.items())),
            "# TYPE cp360_request_seconds_sum counter",
            *(f'cp360_request_seconds_sum{{route="{r}"}} {s:.6f}'
              for r, (s, _) in sorted(lat.items())),
            "# TYPE cp360_request_seconds_count counter",
            *(f'cp360_request_seconds_count{{route="{r}"}} {n}'
              for r, (_, n) in sorted(lat.items())),
            "# TYPE cp360_uptime_seconds gauge",
            f"cp360_uptime_seconds {time.time() - self.started:.1f}",
        ]
        batchers = [("stage1", model._batcher)]
        if model._temporal_batcher is not None:
            batchers.append(("temporal", model._temporal_batcher))
        for metric, kind in (("batches_total", "counter"),
                             ("items_total", "counter"),
                             ("timeouts_total", "counter"),
                             ("max_group", "gauge"),
                             ("busy_seconds", "gauge")):
            lines.append(f"# TYPE cp360_batcher_{metric} {kind}")
            for name, b in batchers:
                stat = metric.removesuffix("_total")
                val = (f"{b.busy_for_s():.3f}" if metric == "busy_seconds"
                       else b.stats[stat])
                lines.append(
                    f'cp360_batcher_{metric}{{batcher="{name}"}} {val}')
        lines.append("# TYPE cp360_data_parallel gauge")
        lines.append(f"cp360_data_parallel {model.data_parallel}")
        lines.append("# TYPE cp360_sessions_active gauge")
        lines.append(f"cp360_sessions_active {len(model._sessions)}")
        return "\n".join(lines) + "\n"


class SaliencyModel:
    """Holds the stage-1 model (and optionally the ConvLSTM + streaming
    sessions) on one device, or replicated over ``mesh_data`` devices;
    thread-safe predict()/temporal_*().

    Args:
      params: the JAX package's param tree of the backbone family ``arch``
        (numpy leaves; resnet18/34/50/101/152, vgg16 or mobilenet_v2),
        carried across by compat/jax_params.py.
      cfg: the serving configuration.
      clstm_params: the ConvLSTM param tree; enables temporal sessions.
      device: "cuda" (default; raises without a card) or "cpu".
      devices: with ``mesh_data`` N > 1, the N replicas' devices (default:
        the first N local devices of ``device``'s kind,
        ``parallel/mesh.py::local_devices``).
    """

    def __init__(self, params: dict, cfg: Config, arch: str = "resnet50",
                 clstm_params: dict | None = None, device="cuda", devices=None):
        from cp360_tpu_torch.compat.jax_params import backbone_from_params, clstm_from_params
        from cp360_tpu_torch.parallel.mesh import LocalReplicas, local_devices
        from cp360_tpu_torch.serving.batcher import DynamicBatcher

        if cfg.upload_format not in ("rgb8", "yuv420"):
            raise ValueError(f"upload_format={cfg.upload_format!r} is not one of "
                             "'rgb8', 'yuv420'")
        self.device = resolve_device(device)
        if cfg.mesh_data > 1:
            devices = ([torch.device(d) for d in devices] if devices is not None
                       else local_devices(self.device, cfg.mesh_data))
            if len(devices) != cfg.mesh_data:
                raise ValueError(f"mesh_data={cfg.mesh_data} needs {cfg.mesh_data} devices, "
                                 f"got {len(devices)}")
            self.device = devices[0]
        self.cfg = cfg
        # yuv420 packs faces sampled on the host, as the extraction does
        self._yuv = cfg.host_cube_remap and cfg.upload_format == "yuv420"
        self.arch = arch
        self.compute_dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                              else torch.float32)
        self.model = backbone_from_params(params, arch, cfg.cube_pad,
                                          self.compute_dtype, self.device)
        self.clstm = None
        if clstm_params is not None:
            self.clstm = clstm_from_params(clstm_params, self.compute_dtype,
                                           cfg.cube_pad, cfg.clstm_conv_impl,
                                           self.device)
        # data-parallel serving: the stage-1 and window batches split over
        # replicas on the devices (predictions equal one device's)
        self.replicas = self.clstm_replicas = None
        if cfg.mesh_data > 1:
            self.replicas = LocalReplicas(self.model, devices)
            if self.clstm is not None:
                self.clstm_replicas = LocalReplicas(self.clstm, devices)
        self.request_metrics = RequestMetrics()
        self._warming = False  # warmup submits bypass the request timeout
        # host-side per-request work (decode, resize, remap); written
        # GIL-atomically by handler threads, read by /healthz
        self.host_stats = {"prep_s": 0.0, "preps": 0,
                           "decode_s": 0.0, "decodes": 0}
        self._lock = threading.Lock()
        self._sessions: dict = {}  # id -> session dict (frames on device)
        max_batch = max(1, cfg.serve_max_batch)
        if self.replicas is not None:
            # device batches are multiples of the data axis: round the
            # operator's cap DOWN to one (min: one row per replica) so the
            # buckets never pad a group above the configured limit
            d = self.data_parallel
            max_batch = max(d, (max_batch // d) * d)
        self._batcher = DynamicBatcher(
            self._run_stage1_batch, max_batch=max_batch,
            window_ms=cfg.serve_batch_window_ms, name="stage1")
        # temporal sessions coalesce too: the window protocol normalizes and
        # seeds state per window, so batching cannot change any prediction
        self._temporal_batcher = None
        if self.clstm is not None:
            self._temporal_batcher = DynamicBatcher(
                self._run_window_batch, max_batch=max_batch,
                window_ms=cfg.serve_batch_window_ms, name="temporal")

    @property
    def data_parallel(self) -> int:
        return len(self.replicas) if self.replicas is not None else 1

    def _bucket(self, n: int, max_batch: int) -> int:
        """The padded batch for n pending requests: a power of two, and with
        replicas also a multiple of their count (even row blocks)."""
        from cp360_tpu_torch.serving.batcher import bucket_size

        b = bucket_size(n, max_batch)
        d = self.data_parallel
        return -(-b // d) * d

    def close(self) -> None:
        """Stop the batcher workers; pending and later requests fail."""
        self._batcher.close()
        if self._temporal_batcher is not None:
            self._temporal_batcher.close()

    def warmup(self) -> None:
        """Run every stage-1 bucket size (and the temporal path) once, so
        the kernels are built and loaded and cuDNN has picked its
        algorithms before the first real request.

        Warmup submits bypass ``serve_request_timeout_s``: a first build
        legitimately takes longer than a request may.
        """
        self._warming = True
        try:
            self._warmup()
        finally:
            self._warming = False

    def _warmup(self) -> None:
        dummy = np.zeros((self.cfg.equi_w, self.cfg.equi_h, 3), np.uint8)
        prep = self._host_prep(dummy)
        b, seen = 1, set()
        while True:
            bs = self._bucket(b, self._batcher.max_batch)
            if bs not in seen:
                seen.add(bs)
                self._run_stage1_batch([prep] * bs)
            if bs >= self._batcher.max_batch:
                break
            b *= 2
        if self.clstm is not None:
            sid = self.temporal_start()
            for _ in range(self.cfg.seq_len):
                self.temporal_push(sid, dummy)
            # the pushes ran the window batch at bucket 1; warm the larger
            # buckets a concurrent-session burst would hit
            window = tuple(self._sessions[sid]["frames"])
            b = 2
            while True:
                bs = self._bucket(b, self._temporal_batcher.max_batch)
                self._run_window_batch([window] * bs)
                if bs >= self._temporal_batcher.max_batch:
                    break
                b *= 2
            self.temporal_close(sid)

    def _host_prep(self, frame_u8: np.ndarray):
        """Resize to the protocol size (PIL, only when needed) and, with
        ``host_cube_remap``, sample the cube faces (cv2) and, with yuv420,
        pack them — pure host work on the calling (HTTP handler) thread, so
        requests prep in parallel.  Returns the upload's parts: (equi,),
        (faces,) or (Y, UV)."""
        t0 = time.monotonic()
        wh = (self.cfg.equi_h, self.cfg.equi_w)
        if frame_u8.shape[:2] == (wh[1], wh[0]):
            equi = frame_u8  # already at protocol size (resize would be identity)
        else:
            from PIL import Image

            img = Image.fromarray(frame_u8).resize(
                wh, resample=getattr(Image, "LANCZOS", Image.Resampling.LANCZOS))
            equi = np.asarray(img, np.uint8)
        if self.cfg.host_cube_remap:
            from cp360_tpu_torch.pipelines.extract import host_faces_for_upload

            out = host_faces_for_upload(equi, self.cfg.cube_dim, self._yuv)
            parts = out if self._yuv else (out,)
        else:
            parts = (np.ascontiguousarray(equi),)
        self.host_stats["prep_s"] += time.monotonic() - t0
        self.host_stats["preps"] += 1
        return parts

    def _run_stage1_batch(self, preps: list):
        """Batcher callback: N prepped requests -> ONE device step.

        Pads the group to a power-of-two bucket (repeating the last item),
        copies the batch's saliency to the host once, and hands each caller
        (scores_i [6, h, w, K] f16 on the device, sal_i [2h, 4w] np.float32).
        """
        from cp360_tpu_torch.pipelines.extract import (
            stage1_batch, stage1_batch_faces, stage1_batch_faces_yuv)

        def step(model, *parts):
            if self._yuv:
                return stage1_batch_faces_yuv(model, *parts, out_dtype=torch.float16)
            if self.cfg.host_cube_remap:
                return stage1_batch_faces(model, parts[0], out_dtype=torch.float16)
            return stage1_batch(model, parts[0], self.cfg.cube_dim, out_dtype=torch.float16)

        n = len(preps)
        b = self._bucket(n, self._batcher.max_batch)
        padded = list(preps) + [preps[-1]] * (b - n)
        with torch.no_grad():
            parts = [torch.from_numpy(np.stack(p)).to(self.device) for p in zip(*padded)]
            if self.replicas is not None:
                scores, sal = self.replicas.run(step, split=parts)
            else:
                scores, sal = step(self.model, *parts)
        sal_np = sal.cpu().numpy()
        return [(scores[i], sal_np[i]) for i in range(n)]

    def _timeout_s(self):
        if self._warming:
            return None  # first builds take long; see warmup()
        t = self.cfg.serve_request_timeout_s
        return t if t > 0 else None

    def _stage1(self, frame_u8: np.ndarray):
        """One frame through the batched stage-1 path.  Returns
        (scores [6, h, w, K] on the device, sal [2h, 4w] np.float32)."""
        return self._batcher.submit(self._host_prep(frame_u8),
                                    timeout_s=self._timeout_s())

    def predict(self, frame_u8: np.ndarray) -> np.ndarray:
        """[H, W, 3] uint8 equi frame -> [2h, 4w] saliency map (f32).

        Thread-safe and batch-coalesced: concurrent callers share one device
        step (see serving/batcher.py)."""
        _, sal = self._stage1(frame_u8)
        return sal

    # ---- temporal streaming sessions ------------------------------------

    def _evict_idle(self) -> None:
        """Drop sessions idle past SESSION_IDLE_TTL_S (callers hold _lock),
        so crashed clients do not pin device memory or the session cap."""
        now = time.monotonic()
        for sid in [s for s, v in self._sessions.items()
                    if now - v["last_used"] > SESSION_IDLE_TTL_S]:
            del self._sessions[sid]

    def temporal_start(self) -> str:
        if self.clstm is None:
            raise LookupError("server started without a ConvLSTM (--clstm)")
        with self._lock:
            self._evict_idle()
            if len(self._sessions) >= MAX_SESSIONS:
                raise OverflowError(f"too many sessions (max {MAX_SESSIONS})")
            sid = uuid.uuid4().hex[:12]
            self._sessions[sid] = {"frames": [], "count": 0,
                                   "last_used": time.monotonic(),
                                   "lock": threading.Lock()}
        return sid

    def _run_window_batch(self, windows: list):
        """Temporal-batcher callback: N session windows -> ONE padded
        ConvLSTM rollout + one copy to the host.

        Each item is a session's rolling tuple of seq_len stage-1 cubes (on
        the device).  Per-window normalization and state seeding make the
        batched predictions equal to running each window alone.
        """
        from cp360_tpu_torch.pipelines.temporal import window_infer

        n = len(windows)
        b = self._bucket(n, self._temporal_batcher.max_batch)
        padded = list(windows) + [windows[-1]] * (b - n)
        with torch.no_grad():
            batch = torch.stack([torch.stack(w) for w in padded])  # [b,T,6,h,w,K]
            if self.clstm_replicas is not None:
                sal = self.clstm_replicas.run(window_infer, split=(batch,))
            else:
                sal = window_infer(self.clstm, batch)
            sal_np = sal.cpu().numpy()
        return [sal_np[i] for i in range(n)]

    def temporal_push(self, sid: str, frame_u8: np.ndarray):
        """Push one frame into a session.

        Returns (frame_index, saliency [2h, 4w] | None): None while fewer
        than seq_len frames are buffered; afterwards the prediction of the
        window ending at this frame (equal to the offline pipeline's
        prediction for that window).

        Pushes within a session serialize on the session's own lock
        (protocol order); different sessions proceed concurrently so their
        stage-1 steps and window inferences group in the two batchers.
        """
        seq_len = self.cfg.seq_len
        with self._lock:
            self._evict_idle()
            sess = self._sessions.get(sid)
            if sess is None:
                raise KeyError(sid)
            sess["last_used"] = time.monotonic()
        with sess["lock"]:
            # session state commits only after every fallible step — a
            # TimeoutError (504) leaves the window untouched so the client
            # can retry the SAME frame
            scores, _ = self._stage1(frame_u8)
            frames = (sess["frames"] + [scores])[-seq_len:]
            idx = sess["count"]
            if len(frames) < seq_len:
                sal = None
            else:
                sal = self._temporal_batcher.submit(
                    tuple(frames), timeout_s=self._timeout_s())
            sess["frames"] = frames
            sess["count"] = idx + 1
            if sal is None:
                return idx, None
        with self._lock:
            if sid in self._sessions:
                sess["last_used"] = time.monotonic()
        return idx, sal

    def temporal_close(self, sid: str) -> None:
        with self._lock:
            if sid not in self._sessions:
                raise KeyError(sid)
            del self._sessions[sid]


def make_handler(model: SaliencyModel):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str = "application/json"):
            self._sent_code = code
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        _KNOWN_ROUTES = frozenset(
            ["healthz", "metrics", "saliency",
             "temporal_session", "temporal_frame", "temporal_close"])

        def _route_label(self) -> str:
            # unknown paths collapse to one label: arbitrary request paths
            # must not grow metric cardinality without bound or inject
            # unescaped characters into the Prometheus exposition
            p = urlparse(self.path).path.rstrip("/")
            if p.startswith("/temporal/"):
                label = "temporal_" + p.split("/")[2]
            else:
                label = p.lstrip("/") or "healthz"
            return label if label in self._KNOWN_ROUTES else "other"

        def do_GET(self):
            t0 = time.monotonic()
            self._sent_code = 0
            try:
                self._get()
            finally:
                model.request_metrics.observe(
                    self._route_label(), self._sent_code,
                    time.monotonic() - t0)

        def do_POST(self):
            t0 = time.monotonic()
            self._sent_code = 0
            try:
                self._post()
            finally:
                model.request_metrics.observe(
                    self._route_label(), self._sent_code,
                    time.monotonic() - t0)

        def _get(self):
            if self.path.rstrip("/") == "/metrics":
                self._send(200, model.request_metrics.render(model).encode(),
                           "text/plain; version=0.0.4")
            elif self.path.rstrip("/") in ("", "/healthz"):
                info = {
                    "status": "ok",
                    "arch": model.arch,
                    "device": str(model.device),
                    "cube_dim": model.cfg.cube_dim,
                    "frame_hw": list(model.cfg.frame_hw),
                    "temporal": model.clstm is not None,
                    "seq_len": model.cfg.seq_len,
                    "data_parallel": model.data_parallel,
                    "batching": {
                        "max_batch": model._batcher.max_batch,
                        "window_ms": model._batcher.window_s * 1000.0,
                        **model._batcher.stats,
                    },
                }
                if model._temporal_batcher is not None:
                    info["temporal_batching"] = dict(model._temporal_batcher.stats)
                info["host"] = dict(model.host_stats)
                self._send(200, json.dumps(info).encode())
            else:
                self._send(404, b'{"error": "not found"}')

        def _read_frame(self):
            length = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(length)
            from PIL import Image

            t0 = time.monotonic()
            img = Image.open(io.BytesIO(raw)).convert("RGB")
            out = np.asarray(img, np.uint8)
            model.host_stats["decode_s"] += time.monotonic() - t0
            model.host_stats["decodes"] += 1
            return out

        def _do_temporal(self, route: str):
            qs = parse_qs(urlparse(self.path).query)
            sid = qs.get("session", [None])[0]
            try:
                if route == "session":
                    self._send(200, json.dumps({"session": model.temporal_start()}).encode())
                elif route == "close":
                    model.temporal_close(sid)
                    self._send(200, b'{"closed": true}')
                elif route == "frame":
                    try:
                        frame = self._read_frame()
                    except Exception as e:
                        self._send(400, json.dumps({"error": f"bad image: {e}"}).encode())
                        return
                    idx, sal = model.temporal_push(sid, frame)
                    if sal is None:
                        body = {"frame": idx, "pending": model.cfg.seq_len - idx - 1}
                    else:
                        body = {"frame": idx, "shape": list(sal.shape),
                                "saliency": sal.tolist()}
                    self._send(200, json.dumps(body).encode())
                else:
                    self._send(404, b'{"error": "not found"}')
            except LookupError as e:  # unknown session / no ConvLSTM loaded
                self._send(404, json.dumps({"error": str(e)}).encode())
            except OverflowError as e:
                self._send(429, json.dumps({"error": str(e)}).encode())
            except TimeoutError as e:  # serve_request_timeout_s exceeded
                self._send(504, json.dumps({"error": str(e)}).encode())
            except Exception as e:  # device error mid-step, batcher closed
                self._send(500, json.dumps({"error": str(e)}).encode())

        def _post(self):
            if self.path.startswith("/temporal/"):
                self._do_temporal(urlparse(self.path).path.split("/")[2])
                return
            if not self.path.startswith("/saliency"):
                self._send(404, b'{"error": "not found"}')
                return
            try:
                frame = self._read_frame()
            except Exception as e:
                self._send(400, json.dumps({"error": f"bad image: {e}"}).encode())
                return

            try:
                sal = model.predict(frame)
            except TimeoutError as e:  # serve_request_timeout_s exceeded
                self._send(504, json.dumps({"error": str(e)}).encode())
                return
            except Exception as e:  # device error mid-step, batcher closed
                self._send(500, json.dumps({"error": str(e)}).encode())
                return
            if "format=png" in self.path:
                lo, hi = float(sal.min()), float(sal.max())
                norm = (sal - lo) / (hi - lo) if hi > lo else sal * 0
                from PIL import Image

                buf = io.BytesIO()
                Image.fromarray((norm * 255).astype(np.uint8), "L").save(buf, "PNG")
                self._send(200, buf.getvalue(), "image/png")
            else:
                body = json.dumps(
                    {"shape": list(sal.shape), "saliency": sal.tolist()}
                ).encode()
                self._send(200, body)

    return Handler


def serve(model: SaliencyModel, host: str = "127.0.0.1", port: int = 8360,
          warmup: bool = True) -> ThreadingHTTPServer:
    """Start the server (returns it; call .serve_forever() or use the CLI)."""
    if warmup:
        model.warmup()
    return ThreadingHTTPServer((host, port), make_handler(model))
