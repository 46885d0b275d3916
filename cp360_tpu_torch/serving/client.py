"""Python client for the saliency HTTP API (stdlib-only, like the server).

The wire protocol is documented in serving/server.py; this wraps it with
encoding, decoding, and the retry semantics the server was designed for:
a 504 means the device step timed out BEFORE the request mutated any
state (temporal pushes commit their session slot only after the device
submit succeeds — server.py), so 504s are safely retryable everywhere;
connection-level failures are retried only on idempotent routes (a lost
response to a temporal push may already have committed server-side).

    from cp360_tpu_torch.serving.client import SaliencyClient

    c = SaliencyClient(port=8360)
    sal = c.saliency(frame)                 # [h, w] float32
    with c.temporal_session() as s:
        for frame in frames:
            out = s.push(frame)             # None until seq_len buffered
"""

from __future__ import annotations

import http.client
import io
import json
import time

import numpy as np


class ServerError(RuntimeError):
    """Non-2xx response: .status and the server's error message."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


def _encode(frame) -> bytes:
    """bytes pass through; [H,W,3] uint8 RGB arrays are PNG-encoded (the
    server decodes via PIL -> RGB, server.py::_read_frame)."""
    if isinstance(frame, (bytes, bytearray)):
        return bytes(frame)
    arr = np.asarray(frame)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected [H,W,3] uint8 RGB or encoded bytes, "
                         f"got {arr.dtype} {arr.shape}")
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, "PNG")
    return buf.getvalue()


class SaliencyClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8360,
                 timeout_s: float = 60.0, retries: int = 2,
                 retry_backoff_s: float = 0.5):
        self.host, self.port = host, port
        self.timeout_s = timeout_s
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s

    # -- transport ---------------------------------------------------------

    def _request(self, method: str, path: str, body: bytes = b"",
                 retryable: bool = True, retry_conn: bool = True):
        """One HTTP exchange with bounded retries.

        ``retryable`` retries 504s (always safe: the server times a step out
        BEFORE mutating any state).  ``retry_conn`` additionally retries
        connection-level failures — safe only for idempotent routes: a lost
        RESPONSE means the server may have processed the request, so
        stateful routes (temporal frame pushes) pass retry_conn=False.

        Returns (status, content_type, payload bytes); raises ServerError
        for non-2xx after retries are exhausted.
        """
        for attempt in range(self.retries + 1):
            if attempt:
                time.sleep(self.retry_backoff_s * attempt)
            try:
                conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=self.timeout_s)
                try:
                    conn.request(method, path, body=body or None)
                    resp = conn.getresponse()
                    data = resp.read()
                    status = resp.status
                    ctype = resp.getheader("Content-Type", "")
                finally:
                    conn.close()
            except (ConnectionError, TimeoutError, OSError):
                if retryable and retry_conn and attempt < self.retries:
                    continue
                raise
            if 200 <= status < 300:
                return status, ctype, data
            if status == 504 and retryable and attempt < self.retries:
                continue  # device step timed out before any state mutated
            try:
                message = json.loads(data).get("error", data.decode())
            except ValueError:
                message = data.decode(errors="replace")
            raise ServerError(status, message)
        raise AssertionError("unreachable")  # every last attempt returns/raises

    def _json(self, method: str, path: str, body: bytes = b"", **kw) -> dict:
        _, _, data = self._request(method, path, body, **kw)
        return json.loads(data)

    # -- stage 1 -----------------------------------------------------------

    def health(self) -> dict:
        return self._json("GET", "/healthz")

    def metrics(self) -> str:
        """Prometheus exposition text."""
        return self._request("GET", "/metrics")[2].decode()

    def saliency(self, frame) -> np.ndarray:
        """Equirectangular frame -> static saliency map [h, w] float32."""
        out = self._json("POST", "/saliency", _encode(frame))
        return np.asarray(out["saliency"], np.float32).reshape(out["shape"])

    def saliency_png(self, frame) -> bytes:
        """Normalized grayscale PNG heatmap bytes."""
        _, ctype, data = self._request("POST", "/saliency?format=png",
                                       _encode(frame))
        if "image/png" not in ctype:
            raise ServerError(500, f"expected image/png, got {ctype!r}")
        return data

    # -- stage 2 (stateful temporal sessions) ------------------------------

    def temporal_session(self) -> "TemporalSession":
        # Not idempotent: a lost RESPONSE may have created a session that
        # would pin a MAX_SESSIONS slot until its idle TTL, so connection
        # failures don't retry (504s still do — they commit no state).
        sid = self._json("POST", "/temporal/session",
                         retry_conn=False)["session"]
        return TemporalSession(self, sid)


class TemporalSession:
    """One server-side streaming session (window protocol, server-resident
    state).  Context manager closes the session on exit."""

    def __init__(self, client: SaliencyClient, session_id: str):
        self._c = client
        self.session_id = session_id
        self.closed = False

    def push(self, frame):
        """Feed one frame.  None while the window is filling (the server
        answers {"pending": k}); afterwards the temporal saliency map
        [h, w] float32 for this frame."""
        out = self._c._json(
            "POST", f"/temporal/frame?session={self.session_id}",
            _encode(frame), retry_conn=False)  # a lost response may have
        # committed the push server-side; only the always-safe 504 retries
        if "saliency" not in out:
            return None
        return np.asarray(out["saliency"], np.float32).reshape(out["shape"])

    def close(self) -> None:
        if not self.closed:
            try:
                # Same lost-response hazard as push(): the first close may
                # have committed, so don't conn-retry, and treat "unknown
                # session" as already closed.
                self._c._json("POST",
                              f"/temporal/close?session={self.session_id}",
                              retry_conn=False)
            except ServerError as e:
                if e.status != 404:
                    raise
            self.closed = True

    def __enter__(self) -> "TemporalSession":
        return self

    def __exit__(self, *exc) -> None:
        try:
            self.close()
        except Exception:
            pass  # the server evicts idle sessions anyway (SESSION_IDLE_TTL_S)
