"""HTTP rendering microservice: POST a render JSON, receive a JPEG.

Re-implements the reference's hand-rolled HTTP/1.1 server
(reference src/http.rs:14-164): a TCP accept loop with a thread per
connection, strict request validation (HTTP/1.1 + POST + application/json +
matching Content-Length -> 505/405/400/415/411), render at the request's
own sample count, and a ``Content-Type: image/jpeg`` quality-90 response.

Differences from the reference, by design:

* requests larger than the reference's single 1 MB read are drained until
  Content-Length is satisfied (the reference truncates silently);
* renders are serialized through a lock — the accelerator is one shared device,
  unlike the reference's per-request CPU thread pools (http.rs:137-138);
* when the native C++ transport (``micro_raytracer_tpu.native``) is built,
  the socket loop runs in C++ and calls back into this module only for the
  render itself; this pure-Python loop is the fallback.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time

from ..models import schema

log = logging.getLogger("raytrace")

_MAX_HEADER = 1 << 20


def render_jpeg(body: bytes, peer: str = "?", mesh=None) -> bytes:
    """Parse a render JSON body and return the rendered JPEG (q90) bytes.

    The core of ``HttpServer::raytrace`` (http.rs:136-148); shared by the
    Python and native transports. ``mesh``: optional device mesh — requests
    then render sharded across it (the CLI's --devices, server-wide).
    """
    from ..models.render import Renderer

    cfg = schema.RenderConfig.from_json(json.loads(body.decode("utf-8")))
    log.info("http:render[%s]: %s", peer, json.dumps(cfg.to_json()))
    r = Renderer(cfg, mesh=mesh)
    sample = 0
    while sample < cfg.rt.sample:
        n = min(16, cfg.rt.sample - sample)
        dt = r.execute_many(n)
        sample += n
        log.info("http:sample[%s]:%d: %.3fs", peer, sample - 1, dt)
    return encode_jpeg(r.img())


def encode_jpeg(img) -> bytes:
    """JPEG q90 of an (H, W, 3) uint8 image: native encoder when built,
    else the numpy one (same algorithm)."""
    from .. import native
    from ..utils import codecs

    if native.available():
        return native.jpeg_encode(img, 90)
    return codecs.encode_jpeg(img, 90)


def _parse_request(raw: bytes):
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) < 3:
        raise ValueError("malformed status line")
    method, uri, version = parts[0], parts[1], parts[2]
    headers = {}
    for line in lines[1:]:
        k, _, v = line.partition(": ")
        if k:
            headers[k] = v
    return method, uri, version, headers, body


class HttpServer:
    """Blocking accept-loop server (http.rs:150-163)."""

    def __init__(self, addr: str, devices: int | None = None, sp: int = 1):
        host, _, port = addr.rpartition(":")
        self.host = host or "0.0.0.0"
        self.port = int(port)
        self._render_lock = threading.Lock()
        self._sock = None
        self.transport = None  # "native" or "python" once started
        self.mesh = None
        if devices:
            from ..parallel.mesh import make_mesh

            self.mesh = make_mesh(devices, sp=sp)
            log.info("http:mesh: %s", dict(self.mesh.shape))

    # -- per-connection handler (http.rs:61-134) --------------------------
    def handle(self, conn: socket.socket, peer) -> None:
        try:
            conn.settimeout(30.0)
            raw = conn.recv(_MAX_HEADER)
            if not raw:
                return
            # headers may span several TCP segments — drain until the blank
            # line (bounded by _MAX_HEADER)
            while b"\r\n\r\n" not in raw and len(raw) < _MAX_HEADER:
                more = conn.recv(_MAX_HEADER)
                if not more:
                    break
                raw += more
            try:
                method, _uri, version, headers, body = _parse_request(raw)
            except ValueError:
                conn.sendall(b"HTTP/1.1 400 Bad Request\r\n")
                return

            # validation order matches http.rs:73-113
            if version != "HTTP/1.1":
                conn.sendall(b"HTTP/1.1 505 HTTP Version Not Supported\r\n")
                return
            if method != "POST":
                conn.sendall(b"HTTP/1.1 405 Method Not Allowed\r\n")
                return
            if "Content-Type" not in headers:
                conn.sendall(b"HTTP/1.1 400 Bad Request\r\n")
                return
            if not headers["Content-Type"].startswith("application/json"):
                conn.sendall(b"HTTP/1.1 415 Unsupported Media Type\r\n")
                return
            if "Content-Length" not in headers:
                conn.sendall(b"HTTP/1.1 411 Length Required\r\n")
                return
            try:
                length = int(headers["Content-Length"])
            except ValueError:
                conn.sendall(b"HTTP/1.1 400 Bad Request\r\n")
                return
            while len(body) < length:  # drain remainder (beyond the ref's 1MB)
                more = conn.recv(_MAX_HEADER)
                if not more:
                    break
                body += more
            if len(body) != length:
                conn.sendall(b"HTTP/1.1 400 Bad Request\r\n")
                return

            t0 = time.perf_counter()
            with self._render_lock:
                jpg = render_jpeg(body, peer=str(peer), mesh=self.mesh)
            log.info("http:done[%s]: %.3fs", peer, time.perf_counter() - t0)

            head = (f"HTTP/1.1 200 OK\r\nContent-Type: image/jpeg\r\n"
                    f"Content-Length: {len(jpg)}\r\n\r\n").encode()
            conn.sendall(head + jpg + b"\r\n")
        except Exception as e:  # noqa: BLE001 — per-connection isolation
            log.error("http: %s", e)
            try:
                conn.sendall(b"HTTP/1.1 500 Internal Server Error\r\n")
            except OSError:
                pass
        finally:
            conn.close()

    # -- accept loop -------------------------------------------------------
    def start(self) -> None:
        """Serve forever; prefers the native C++ transport when built."""
        from .. import native

        if native.available() and os.environ.get("MRT_NO_NATIVE") != "1":
            log.info("http: native transport on %s:%d", self.host, self.port)
            self.transport = "native"

            def render_locked(body: bytes) -> bytes:
                with self._render_lock:
                    return render_jpeg(body, peer="native", mesh=self.mesh)

            rc = native.http_serve(self.host, self.port, render_locked)
            if rc != 0:
                raise OSError(f"native http transport failed: rc={rc}")
            return
        self._start_python()

    def stop(self) -> None:
        """Close the listening socket; :meth:`start` then returns."""
        if self.transport == "native":
            from .. import native

            native.http_stop()
        elif self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()

    def _start_python(self) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.host, self.port))
        srv.listen(64)
        self._sock = srv
        self.transport = "python"
        log.info("http: listening on %s:%d", self.host, self.port)
        while True:
            try:
                conn, peer = srv.accept()
            except OSError:  # closed by stop()
                return
            log.info("http:connected: %s", peer)
            threading.Thread(target=self.handle, args=(conn, peer),
                             daemon=True).start()
