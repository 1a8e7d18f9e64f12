"""A real HTTP transport for the CWSI (stdlib only).

The CWSI was designed so its in-process ``dumps``/``loads`` seam could be
"swapped for HTTP without touching either side" — this module is that
swap. ``CWSIHTTPServer`` fronts an existing ``CWSIServer.handle`` with a
``ThreadingHTTPServer``; ``http_transport`` produces the matching
``str -> str`` callable so ``CWSIClient(transport=...)`` works unchanged
against a remote scheduler.

Semantics are deliberately thin:

* Every request maps verbatim onto a CWSI message ``{method, path,
  body}`` — the CWSI's own routing decides method case, unknown paths,
  and body validation, so in-process and HTTP deployments share one
  conformance surface. The HTTP status line is always 200; the CWSI
  status travels inside the JSON envelope (it is protocol data, not
  transport data).
* A body that is not valid JSON is answered 400 *by the transport*,
  without ever touching the server — a malformed request must not reach
  the engine, let alone its journal.
* Handler threads serialise through a single writer lock around
  ``handle``: the engine below is not thread-safe, and the journal's
  write-ahead ordering (append, then apply) must not interleave. Reads
  take the same lock — snapshot consistency is worth more than read
  concurrency at CWSI rates.
* The transport defends its own threads. A mutating request without a
  ``Content-Length`` (or with a negative/unparseable one) is a 400 —
  the handler will not guess at framing. A declared length above
  ``max_body_bytes`` is a 400 before a single body byte is read. With
  ``read_timeout`` set, a stalled body is a 408 instead of a thread
  parked forever on ``rfile.read`` (the stdlib default). With
  ``max_inflight`` set, excess concurrent requests are shed with a 503
  + ``Retry-After`` instead of queued without bound — the retrying
  client (``cwsi_client.ReliableCWSIClient``) backs off and returns.
  All transport-level rejects close the connection (the unread body
  would poison keep-alive framing) and never reach the engine.
"""
from __future__ import annotations

import json
import socket
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

from .cwsi import CWSIServer, _Request


class CWSIHTTPServer:
    """Serve a ``CWSIServer`` over HTTP on a daemon thread.

    ``port=0`` (the default) binds an ephemeral port; read ``address``
    (host, port) or ``url`` after construction. ``stop()`` shuts the
    listener down; the object is also a context manager.

    ``max_inflight`` bounds concurrently handled requests (excess is
    shed with 503 + ``Retry-After``), ``read_timeout`` bounds how long a
    handler thread waits on a stalled request body (408), and
    ``max_body_bytes`` caps the declared ``Content-Length`` (400). All
    default to the historical unguarded behaviour except the body cap.
    """

    def __init__(self, server: CWSIServer, host: str = "127.0.0.1",
                 port: int = 0, max_inflight: Optional[int] = None,
                 read_timeout: Optional[float] = None,
                 max_body_bytes: int = 8 << 20) -> None:
        self.cwsi = server
        self._lock = threading.Lock()
        self.max_body_bytes = int(max_body_bytes)
        self._inflight = (threading.Semaphore(max_inflight)
                          if max_inflight is not None else None)
        self.shed_requests = 0       # 503: over max_inflight
        self.rejected_bodies = 0     # 400: Content-Length missing/bad/huge
        self.timed_out_requests = 0  # 408: body stalled past read_timeout
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # socketserver applies this to the connection socket, so a
            # client that stalls mid-body (or mid-request-line) raises
            # socket.timeout instead of parking the thread forever
            timeout = read_timeout

            # Accept ANY method token (GET, put, PATCH, ...): the CWSI
            # owns method semantics, including normalising case and
            # 404-ing verbs it has no route for. BaseHTTPRequestHandler
            # dispatches to do_<METHOD>, so resolve them all to _handle.
            def __getattr__(self, name: str):
                if name.startswith("do_"):
                    return self._handle
                raise AttributeError(name)

            def _handle(self) -> None:
                if outer._inflight is not None \
                        and not outer._inflight.acquire(blocking=False):
                    # overload shedding: bounded in-flight work; the
                    # excess is told when to come back, not queued
                    outer.shed_requests += 1
                    self._refuse(503, "server overloaded, retry later",
                                 headers={"Retry-After": "1"})
                    return
                try:
                    self._serve()
                finally:
                    if outer._inflight is not None:
                        outer._inflight.release()

            def _serve(self) -> None:
                cl = self.headers.get("Content-Length")
                if cl is None:
                    if self.command.upper() in ("POST", "PUT", "PATCH"):
                        # a mutating request without a declared length
                        # could only be framed by chunked encoding
                        # (unsupported) or connection close; reject
                        # instead of guessing
                        outer.rejected_bodies += 1
                        self._refuse(400, "missing Content-Length")
                        return
                    length = 0
                else:
                    try:
                        length = int(cl)
                    except ValueError:
                        length = -1
                    if length < 0:
                        outer.rejected_bodies += 1
                        self._refuse(400, "invalid Content-Length")
                        return
                    if length > outer.max_body_bytes:
                        outer.rejected_bodies += 1
                        self._refuse(
                            400, f"request body exceeds "
                                 f"{outer.max_body_bytes} bytes")
                        return
                try:
                    raw = self.rfile.read(length) if length else b""
                except socket.timeout:
                    # stalled body: free the thread with a 408 instead
                    # of blocking on the remaining bytes indefinitely
                    outer.timed_out_requests += 1
                    self._refuse(408, "timed out reading request body")
                    return
                body: Optional[Any] = None
                if raw:
                    try:
                        body = json.loads(raw)
                    except ValueError:
                        # transport-level reject: the engine (and its
                        # journal) never sees a request that failed to
                        # parse
                        self._reply({"status": 400, "body": {
                            "error": "request body is not valid JSON"}})
                        return
                message = json.dumps({"method": self.command,
                                      "path": self.path, "body": body})
                with outer._lock:
                    resp = outer.cwsi.handle(message)
                self._reply(json.loads(resp))

            def _refuse(self, status: int, error: str,
                        headers: Optional[Dict[str, str]] = None) -> None:
                # transport-level reject with an unread (or unreadable)
                # body on the wire: keep-alive framing is gone, so the
                # connection closes with the response
                self.close_connection = True
                self._reply({"status": status, "body": {"error": error}},
                            headers=headers)

            def _reply(self, envelope: Any,
                       headers: Optional[Dict[str, str]] = None) -> None:
                payload = json.dumps(envelope).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, fmt: str, *args: Any) -> None:
                pass                     # tests run thousands of requests

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="cwsi-http")
        self._thread.start()

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self._httpd.server_address[:2]
        return str(host), int(port)

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "CWSIHTTPServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()


def http_transport(base_url: str,
                   timeout: float = 30.0) -> Callable[[str], str]:
    """A ``str -> str`` CWSI transport over HTTP.

    Decodes the client's serialised message, issues the same method/path/
    body as a real HTTP request against ``base_url``, and returns the
    response envelope — so ``CWSIClient(transport=http_transport(url))``
    is wire-identical to the in-process client.
    """
    base = base_url.rstrip("/")

    def transport(raw: str) -> str:
        req = _Request.decode(raw)
        data = (json.dumps(req.body).encode()
                if req.body is not None else None)
        http_req = urllib.request.Request(
            base + req.path, data=data, method=req.method,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(http_req, timeout=timeout) as resp:
            return resp.read().decode()

    return transport
