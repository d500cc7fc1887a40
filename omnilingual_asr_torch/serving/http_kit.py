"""Minimal dependency-free HTTP server kit: router, multipart parsing, JSON
and SSE responses.

The reference's local server uses FastAPI + sse-starlette (reference
workflows/wav2elan_web/app.py); this environment has neither, so the serving
layer runs on a small stdlib-only kit that speaks the exact same wire
formats: JSON bodies, multipart/form-data uploads, and `event:`/`data:` SSE
framing (the shape the SPA's manual SSE reader parses, reference
public/static/app.js:2308-2360).

The PyTorch port's own copy of ``omnilingual_asr_tpu/serving/http_kit.py``
(the port imports nothing of the JAX package); keep the two in step.
"""

from __future__ import annotations

import json
import re
import threading
import urllib.parse
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple


@dataclass
class UploadedFile:
    filename: str
    content: bytes
    content_type: str = "application/octet-stream"


@dataclass
class Request:
    method: str
    path: str
    query: Dict[str, str]
    headers: Dict[str, str]
    body: bytes
    path_params: Dict[str, str] = field(default_factory=dict)
    context: Dict[str, Any] = field(default_factory=dict)  # middleware data

    def json(self) -> Any:
        return json.loads(self.body.decode("utf-8") or "null")

    def form(self) -> Tuple[Dict[str, str], Dict[str, List[UploadedFile]]]:
        """Parse multipart/form-data (or urlencoded) bodies.

        Returns (fields, files) where files maps field name -> list of
        uploads (list because batch endpoints accept repeated `files`)."""
        ctype = self.headers.get("content-type", "")
        if ctype.startswith("application/x-www-form-urlencoded"):
            fields = dict(urllib.parse.parse_qsl(self.body.decode()))
            return fields, {}
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if not m:
            return {}, {}
        boundary = m.group(1).encode()
        return _parse_multipart(self.body, boundary)


def _parse_multipart(body: bytes, boundary: bytes):
    fields: Dict[str, str] = {}
    files: Dict[str, List[UploadedFile]] = {}
    delim = b"--" + boundary
    parts = body.split(delim)
    for part in parts[1:]:
        if part in (b"--", b"--\r\n", b"", b"\r\n"):
            continue
        part = part.lstrip(b"\r\n")
        if part.endswith(b"\r\n"):
            part = part[:-2]
        head, _, payload = part.partition(b"\r\n\r\n")
        headers = {}
        for line in head.split(b"\r\n"):
            k, _, v = line.partition(b":")
            headers[k.decode().lower().strip()] = v.decode().strip()
        disp = headers.get("content-disposition", "")
        name_m = re.search(r'name="([^"]*)"', disp)
        if not name_m:
            continue
        name = name_m.group(1)
        file_m = re.search(r'filename="([^"]*)"', disp)
        if file_m:
            files.setdefault(name, []).append(UploadedFile(
                filename=file_m.group(1), content=payload,
                content_type=headers.get("content-type",
                                         "application/octet-stream")))
        else:
            fields[name] = payload.decode("utf-8", errors="replace")
    return fields, files


class Response:
    def __init__(self, body: bytes = b"", status: int = 200,
                 content_type: str = "text/plain; charset=utf-8",
                 headers: Optional[Dict[str, str]] = None):
        self.body = body
        self.status = status
        self.content_type = content_type
        self.headers = headers or {}


class JSONResponse(Response):
    def __init__(self, data: Any, status: int = 200):
        super().__init__(json.dumps(data).encode("utf-8"), status,
                         "application/json")


class HTTPError(Exception):
    """Maps to the FastAPI HTTPException JSON shape: {"detail": ...}."""

    def __init__(self, status_code: int, detail: str):
        super().__init__(detail)
        self.status_code = status_code
        self.detail = detail


class SSEResponse(Response):
    """Server-sent events from a generator yielding {"event": ..., "data": ...}.

    Framing matches what both reference servers emit: `event: <name>\\n
    data: <json>\\n\\n` (app.py via sse-starlette; transcribe-stream.js
    sseEvent :4-6)."""

    def __init__(self, events: Iterator[Dict[str, str]]):
        super().__init__(b"", 200, "text/event-stream")
        self.events = events


Handler = Callable[[Request], Response]


class Router:
    def __init__(self):
        self.routes: List[Tuple[str, re.Pattern, Handler]] = []

    def add(self, method: str, pattern: str, handler: Handler):
        """pattern: /api/history/{id} -> named groups."""
        regex = re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern)
        self.routes.append((method.upper(), re.compile(f"^{regex}$"), handler))

    def route(self, method: str, pattern: str):
        def deco(fn):
            self.add(method, pattern, fn)
            return fn
        return deco

    def dispatch(self, req: Request) -> Optional[Response]:
        for method, regex, handler in self.routes:
            if method != req.method:
                continue
            m = regex.match(req.path)
            if m:
                req.path_params = m.groupdict()
                return handler(req)
        return None


class AppServer:
    """Threaded HTTP server around a Router, with optional middleware.

    middleware: callable(req) -> Optional[Response]; returning a Response
    short-circuits (used for the auth gate, mirroring the reference's
    Cloudflare _middleware.js:13-61)."""

    def __init__(self, router: Router,
                 middleware: Optional[Callable[[Request], Optional[Response]]] = None):
        self.router = router
        self.middleware = middleware
        self._httpd: Optional[ThreadingHTTPServer] = None

    def handle(self, req: Request) -> Response:
        try:
            if self.middleware is not None:
                short = self.middleware(req)
                if short is not None:
                    return short
            resp = self.router.dispatch(req)
            if resp is None:
                return JSONResponse({"detail": "Not Found"}, 404)
            return resp
        except HTTPError as e:
            return JSONResponse({"detail": e.detail}, e.status_code)
        except Exception as e:  # noqa: BLE001
            return JSONResponse({"detail": f"Internal error: {e}"}, 500)

    # -- stdlib server plumbing -------------------------------------------

    def _make_handler(self):
        app = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _req(self) -> Request:
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                parsed = urllib.parse.urlsplit(self.path)
                return Request(
                    method=self.command,
                    path=parsed.path,
                    query=dict(urllib.parse.parse_qsl(parsed.query)),
                    headers={k.lower(): v for k, v in self.headers.items()},
                    body=body,
                )

            def _respond(self):
                resp = app.handle(self._req())
                if isinstance(resp, SSEResponse):
                    self.send_response(resp.status)
                    self.send_header("Content-Type", resp.content_type)
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    try:
                        for ev in resp.events:
                            frame = (f"event: {ev['event']}\n"
                                     f"data: {ev['data']}\n\n").encode()
                            self.wfile.write(frame)
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                    return
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.content_type)
                self.send_header("Content-Length", str(len(resp.body)))
                for k, v in resp.headers.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(resp.body)

            do_GET = do_POST = do_PUT = do_DELETE = _respond

        return _Handler

    def serve(self, host: str = "127.0.0.1", port: int = 8000):
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._httpd.daemon_threads = True
        self._httpd.serve_forever()

    def serve_background(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start in a daemon thread; returns the bound port."""
        httpd = ThreadingHTTPServer((host, port), self._make_handler())
        httpd.daemon_threads = True
        self._httpd = httpd
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd.server_address[1]

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
