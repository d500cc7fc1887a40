"""The web API server: identical routes to the reference's local FastAPI app
(reference workflows/wav2elan_web/app.py) merged with the serverless
deployment's feature set (reference functions/api/*): JWT auth, SQLite
history mirroring the D1 schema, audio blob serving, and the orthography
hint that only the serverless variant supported (reference
_gemini.js:86-114).

Runs on the stdlib http kit (no FastAPI in this environment) but speaks the
exact same wire formats, so the reference's SPA clients work unchanged.

The PyTorch port's own copy of ``omnilingual_asr_tpu/serving/app.py`` (the
port imports nothing of the JAX package); keep the two in step. Its default
engine is the port's ``TranscriptionEngine``, which runs on the CUDA card
and raises where there is none; tests pass ``engine`` or ``engine_factory``
(a ``FakeEngine``, or an engine built with ``device="cpu"``). Start it with
``python -m omnilingual_asr_torch.serving.app --port 8000`` (``--auth``,
``--memory``, ``--data-dir``).

Route map:
  GET  /                            SPA index
  GET  /static/<path>, /uploads/<path>
  POST /api/transcribe              sync JSON            (app.py:157-173)
  POST /api/transcribe-stream       SSE progress+result  (app.py:176-271)
  POST /api/transcribe-batch-stream SSE batch            (app.py:274-417)
  GET/PUT/DELETE /api/history[/{id}]                     (app.py:420-460)
  POST /api/auth/register|login, GET /api/auth/me        (functions/api/auth/*)
  GET  /api/audio/{id}                                   (functions/api/audio/[id].js)
"""

from __future__ import annotations

import json
import mimetypes
import queue
import threading
import uuid
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from . import auth as auth_mod
from .history import MemoryHistory, SqliteHistory
from .http_kit import (
    AppServer,
    HTTPError,
    JSONResponse,
    Request,
    Response,
    Router,
    SSEResponse,
    UploadedFile,
)
from .schema import result_to_entry

AUDIO_EXTS = {".wav", ".mp3", ".flac", ".ogg", ".m4a"}
UPLOAD_EXTS = AUDIO_EXTS | {".zip"}
MAX_PARALLEL_FILES = 4  # reference app.py:384-385
PUBLIC_PATHS = {"/api/auth/register", "/api/auth/login"}  # _middleware.js:4-7


def _accepts_kwarg(fn, name: str) -> bool:
    """True if fn accepts keyword `name` (explicitly or via **kwargs)."""
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return True
    params = sig.parameters
    if name in params:
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values())


def _is_audio_file(path: Path) -> bool:
    return path.suffix.lower() in AUDIO_EXTS


def _safe_extract_zip(zip_path: Path, dest_dir: Path) -> List[Tuple[Path, str]]:
    """Zip extraction refusing traversal (reference app.py:80-95)."""
    extracted: List[Tuple[Path, str]] = []
    with zipfile.ZipFile(zip_path) as zf:
        for info in zf.infolist():
            if info.is_dir():
                continue
            member = Path(info.filename)
            if ".." in member.parts or member.is_absolute():
                continue
            target = dest_dir / member
            target.parent.mkdir(parents=True, exist_ok=True)
            with zf.open(info) as src:
                target.write_bytes(src.read())
            if _is_audio_file(target):
                extracted.append((target, member.as_posix()))
    return extracted


class OmniServer:
    """Application wiring: engine + history + auth + routes."""

    def __init__(self, *, engine=None, base_dir: Optional[Path] = None,
                 auth_required: bool = False, use_sqlite: bool = True,
                 engine_factory=None):
        self.base_dir = Path(base_dir) if base_dir else Path.cwd() / "omniasr_data"
        self.upload_dir = self.base_dir / "uploads"
        self.static_dir = Path(__file__).parent / "static"
        self.upload_dir.mkdir(parents=True, exist_ok=True)

        self._engine = engine
        self._engine_factory = engine_factory
        self._engine_lock = threading.Lock()
        self.auth_required = auth_required
        self.jwt_secret = auth_mod.get_jwt_secret(self.base_dir)

        if use_sqlite:
            self.history = SqliteHistory(self.base_dir / "history.db",
                                         audio_dir=self.base_dir)
        else:
            self.history = MemoryHistory()

        self.router = Router()
        self._register_routes()
        self.app = AppServer(self.router, middleware=self._auth_middleware)

    # ------------------------------------------------------------------

    def engine(self):
        """Lazy singleton engine (reference app.py:43-54) — created on first
        transcription so the server starts instantly."""
        with self._engine_lock:
            if self._engine is None:
                if self._engine_factory is not None:
                    self._engine = self._engine_factory()
                else:
                    import os

                    from ..engine import TranscriptionEngine

                    self._engine = TranscriptionEngine(
                        long_mode=os.getenv("OMNIASR_LONG_MODE", "window"))
            return self._engine

    # -- middleware ------------------------------------------------------

    def _auth_middleware(self, req: Request) -> Optional[Response]:
        if not self.auth_required:
            return None
        path = req.path.rstrip("/") or "/"
        if (not path.startswith("/api")) or path in PUBLIC_PATHS:
            return None
        token = auth_mod.get_bearer_token(req.headers)
        if not token:
            return JSONResponse({"error": "Authentication required."}, 401)
        payload = auth_mod.verify_jwt(token, self.jwt_secret)
        if not payload or not payload.get("sub"):
            return JSONResponse({"error": "Invalid or expired token."}, 401)
        req.context["userId"] = payload["sub"]
        req.context["email"] = payload.get("email")
        return None

    def _user(self, req: Request) -> Optional[str]:
        if self.auth_required:
            return req.context.get("userId")
        # wav2elan shell protocol (reference workflows/wav2elan_web/static/
        # app.js:1-33): the client generates a 12-char session key and sends
        # it as x-session-key on every /api call "to isolate each user's
        # workspace". The reference SERVER never reads it (history is
        # global); here it actually namespaces history when auth is off.
        key = req.headers.get("x-session-key")
        if key and len(key) <= 64 and key.isalnum():
            return f"sk:{key}"
        return None

    # -- helpers -----------------------------------------------------------

    def _save_upload(self, up: UploadedFile, dest: Path) -> Tuple[Path, str]:
        if not up.filename:
            raise HTTPError(400, "Missing file name.")
        ext = Path(up.filename).suffix.lower()
        if ext not in UPLOAD_EXTS:
            raise HTTPError(400, "Unsupported file type.")
        out = dest / f"{uuid.uuid4().hex}{ext}"
        out.write_bytes(up.content)
        return out, up.filename

    def _transcribe_to_entry(self, audio_path: Path, display_name: str,
                             audio_url: str, *, language=None,
                             speaker_count=None, orthography=None,
                             progress_cb=None) -> Dict[str, Any]:
        kwargs = dict(progress_callback=progress_cb, language=language,
                      speaker_count=speaker_count)
        engine = self.engine()
        if orthography and _accepts_kwarg(engine.transcribe_with_retry,
                                          "orthography"):
            # engine extension of the serverless-only hint; fake/test
            # engines may not accept it
            kwargs["orthography"] = orthography
        result = engine.transcribe_with_retry(str(audio_path), **kwargs)
        entry = result_to_entry(result, file_name=display_name,
                                audio_url=audio_url)
        return entry

    def _store_entry(self, entry: Dict[str, Any], user: Optional[str],
                     audio_path: Path) -> Dict[str, Any]:
        """Persist a history entry and, in SQLite mode, the audio blob keyed
        audio/{id}.{ext} (the reference serverless flow, transcribe-stream.js
        :55 + _history.js:222-230), so GET /api/audio/{id} serves it."""
        entry = self.history.put(entry, user)
        if isinstance(self.history, SqliteHistory):
            try:
                self.history.store_audio(entry["id"],
                                         audio_path.suffix.lower(),
                                         audio_path.read_bytes())
            except OSError:
                pass  # blob storage is best-effort; uploads dir still serves
        return entry

    # -- routes ------------------------------------------------------------

    def _register_routes(self):
        r = self.router

        @r.route("GET", "/")
        def index(req: Request) -> Response:
            idx = self.static_dir / "index.html"
            if idx.exists():
                return Response(idx.read_bytes(), 200,
                                "text/html; charset=utf-8")
            return Response(b"<html><body><h1>OmniScribe TPU</h1>"
                            b"<p>API is running.</p></body></html>", 200,
                            "text/html; charset=utf-8")

        @r.route("GET", "/wav2elan")
        def wav2elan_shell(req: Request) -> Response:
            """The reference's SECOND frontend shell (workflows/
            wav2elan_web/static/): same workflows, but a client-side
            password gate + anonymous per-browser session key
            (x-session-key header) instead of the JWT account shell.
            Served as the same SPA bootstrapped in wav2elan mode."""
            idx = self.static_dir / "index.html"
            if not idx.exists():
                raise HTTPError(404, "Not Found")
            html = idx.read_text()
            html = html.replace(
                "<head>",
                '<head><script>window.OMNI_SHELL="wav2elan";</script>', 1)
            return Response(html.encode(), 200, "text/html; charset=utf-8")

        @r.route("GET", "/static/{path}")
        def static_file(req: Request) -> Response:
            return self._serve_file(self.static_dir, req.path_params["path"])

        @r.route("GET", "/uploads/{path}")
        def upload_file(req: Request) -> Response:
            return self._serve_file(self.upload_dir, req.path_params["path"])

        @r.route("GET", "/uploads/{batch}/{path}")
        def upload_batch_file(req: Request) -> Response:
            return self._serve_file(
                self.upload_dir,
                f"{req.path_params['batch']}/{req.path_params['path']}")

        # ---- transcription ------------------------------------------------

        @r.route("POST", "/api/transcribe")
        def transcribe(req: Request) -> Response:
            fields, files = req.form()
            ups = files.get("file")
            if not ups:
                raise HTTPError(400, "Missing file name.")
            path, display = self._save_upload(ups[0], self.upload_dir)
            if path.suffix.lower() == ".zip":
                raise HTTPError(400, "Use batch endpoint for zip uploads.")
            entry = self._transcribe_to_entry(
                path, display, f"/uploads/{path.name}",
                language=fields.get("language") or None,
                speaker_count=fields.get("speaker_count") or None,
                orthography=fields.get("orthography") or None)
            entry = self._store_entry(entry, self._user(req), path)
            return JSONResponse(entry)

        @r.route("POST", "/api/transcribe-stream")
        def transcribe_stream(req: Request) -> Response:
            fields, files = req.form()
            ups = files.get("file")
            if not ups:
                raise HTTPError(400, "Missing file name.")
            path, display = self._save_upload(ups[0], self.upload_dir)
            if path.suffix.lower() == ".zip":
                raise HTTPError(400, "Use batch endpoint for zip uploads.")
            user = self._user(req)

            def events():
                q: queue.Queue = queue.Queue()
                done = object()

                def cb(step: str, idx: int, fraction: float = None):
                    item = {"step": step, "index": idx, "file_name": display}
                    if fraction is not None:
                        # intra-step progress (device batches completed /
                        # total) — keeps long files moving past step 1
                        item["fraction"] = round(fraction, 4)
                    q.put(item)

                holder: Dict[str, Any] = {}

                def work():
                    try:
                        holder["entry"] = self._transcribe_to_entry(
                            path, display, f"/uploads/{path.name}",
                            language=fields.get("language") or None,
                            speaker_count=fields.get("speaker_count") or None,
                            orthography=fields.get("orthography") or None,
                            progress_cb=cb)
                    except Exception as e:  # noqa: BLE001
                        holder["error"] = str(e)
                    finally:
                        q.put(done)

                t = threading.Thread(target=work, daemon=True)
                t.start()
                while True:
                    item = q.get()
                    if item is done:
                        break
                    yield {"event": "progress", "data": json.dumps(item)}
                if "error" in holder:
                    yield {"event": "error",
                           "data": json.dumps({"error": holder["error"]})}
                    return
                entry = self._store_entry(holder["entry"], user, path)
                yield {"event": "result", "data": json.dumps(entry)}

            return SSEResponse(events())

        @r.route("POST", "/api/transcribe-stream-live")
        def transcribe_stream_live(req: Request) -> Response:
            """Extension route: like /api/transcribe-stream but also emits
            'segments' events as device batches finish (incremental
            transcript), via engine.transcribe_streaming. Reference routes
            stay byte-stable; clients ignoring unknown events still work."""
            fields, files = req.form()
            ups = files.get("file")
            if not ups:
                raise HTTPError(400, "Missing file name.")
            path, display = self._save_upload(ups[0], self.upload_dir)
            if path.suffix.lower() == ".zip":
                raise HTTPError(400, "Use batch endpoint for zip uploads.")
            user = self._user(req)
            eng = self.engine()
            if not hasattr(eng, "transcribe_streaming"):
                raise HTTPError(501, "Engine does not support streaming.")

            def events():
                yield {"event": "progress", "data": json.dumps(
                    {"step": "uploading", "index": 0, "file_name": display})}
                try:
                    gen = eng.transcribe_streaming(
                        str(path),
                        language=fields.get("language") or None,
                        speaker_count=fields.get("speaker_count") or None,
                        orthography=fields.get("orthography") or None)
                    yield {"event": "progress", "data": json.dumps(
                        {"step": "transcribing", "index": 1,
                         "file_name": display})}
                    final = None
                    for kind, payload in gen:
                        if kind == "partial":
                            from .schema import segments_to_wire

                            from ..types import TranscriptionResult

                            wire = segments_to_wire(
                                TranscriptionResult(segments=payload))
                            yield {"event": "segments",
                                   "data": json.dumps({"segments": wire})}
                        else:
                            final = payload
                    yield {"event": "progress", "data": json.dumps(
                        {"step": "processing", "index": 2,
                         "file_name": display})}
                    entry = result_to_entry(
                        final, file_name=display,
                        audio_url=f"/uploads/{path.name}")
                    entry = self._store_entry(entry, user, path)
                    yield {"event": "progress", "data": json.dumps(
                        {"step": "done", "index": 3, "file_name": display})}
                    yield {"event": "result", "data": json.dumps(entry)}
                except Exception as e:  # noqa: BLE001
                    yield {"event": "error",
                           "data": json.dumps({"error": str(e)})}

            return SSEResponse(events())

        @r.route("POST", "/api/transcribe-batch-stream")
        def transcribe_batch_stream(req: Request) -> Response:
            fields, files = req.form()
            ups = files.get("files") or files.get("file")
            if not ups:
                raise HTTPError(400, "No files uploaded.")
            batch_id = uuid.uuid4().hex
            batch_dir = self.upload_dir / batch_id
            batch_dir.mkdir(parents=True, exist_ok=True)
            audio_files: List[Tuple[Path, str]] = []
            for up in ups:
                saved, display = self._save_upload(up, batch_dir)
                if saved.suffix.lower() == ".zip":
                    audio_files.extend(_safe_extract_zip(saved, batch_dir))
                elif _is_audio_file(saved):
                    audio_files.append((saved, display))
            if not audio_files:
                raise HTTPError(400, "No supported audio files found.")
            user = self._user(req)
            language = fields.get("language") or None
            speaker_count = fields.get("speaker_count") or None
            orthography = fields.get("orthography") or None

            def events():
                q: queue.Queue = queue.Queue()
                file_count = len(audio_files)
                results: List[Optional[dict]] = [None] * file_count
                sem = threading.Semaphore(min(MAX_PARALLEL_FILES, file_count))
                remaining = threading.Semaphore(0)

                def work(i: int, path: Path, display: str):
                    with sem:
                        def cb(step: str, idx: int, fraction: float = None):
                            item = {"step": step, "index": idx,
                                    "file_index": i,
                                    "file_count": file_count,
                                    "file_name": display}
                            if fraction is not None:
                                item["fraction"] = round(fraction, 4)
                            q.put(item)
                        try:
                            entry = self._transcribe_to_entry(
                                path, display,
                                f"/uploads/{batch_id}/{path.name}",
                                language=language,
                                speaker_count=speaker_count,
                                orthography=orthography, progress_cb=cb)
                            results[i] = self._store_entry(entry, user, path)
                        except Exception as e:  # noqa: BLE001
                            q.put({"step": "error", "index": -1,
                                   "file_index": i, "file_count": file_count,
                                   "file_name": display, "error": str(e)})
                        finally:
                            remaining.release()

                for i, (p, d) in enumerate(audio_files):
                    threading.Thread(target=work, args=(i, p, d),
                                     daemon=True).start()
                finished = 0
                while finished < file_count:
                    if remaining.acquire(timeout=0.05):
                        finished += 1
                    while True:
                        try:
                            payload = q.get_nowait()
                        except queue.Empty:
                            break
                        yield {"event": "progress", "data": json.dumps(payload)}
                while True:
                    try:
                        payload = q.get_nowait()
                    except queue.Empty:
                        break
                    yield {"event": "progress", "data": json.dumps(payload)}
                yield {"event": "result", "data": json.dumps(
                    {"results": [r for r in results if r is not None]})}

            return SSEResponse(events())

        # ---- history ------------------------------------------------------

        @r.route("GET", "/api/history")
        def list_history(req: Request) -> Response:
            return JSONResponse(self.history.list(self._user(req)))

        @r.route("GET", "/api/history/{history_id}")
        def get_history(req: Request) -> Response:
            entry = self.history.get(req.path_params["history_id"],
                                     self._user(req))
            if entry is None:
                raise HTTPError(404, "History entry not found.")
            return JSONResponse(entry)

        @r.route("PUT", "/api/history/{history_id}")
        def update_history(req: Request) -> Response:
            payload = req.json()
            hid = req.path_params["history_id"]
            user = self._user(req)
            old = self.history.get(hid, user)
            if old is None:
                raise HTTPError(404, "History entry not found.")
            updated = self.history.update(hid, payload, user)
            if isinstance(self.history, SqliteHistory):
                for field in ("file_name", "segments"):
                    if field in payload:
                        self.history.log_edit(hid, field, old.get(field),
                                              payload[field])
            return JSONResponse(updated)

        @r.route("DELETE", "/api/history/{history_id}")
        def delete_history(req: Request) -> Response:
            ok = self.history.delete(req.path_params["history_id"],
                                     self._user(req))
            if not ok:
                # reference history/[id].js:53-58 — user-scoped miss is 404
                return JSONResponse({"error": "Not found"}, 404)
            return JSONResponse({"ok": True})

        @r.route("GET", "/api/demo")
        def demo(req: Request) -> Response:
            """Built-in demo transcript (reference ships DEMO_EXAMPLE in the
            SPA, wav2elan app.js:180-277); served so the client can show a
            working example before any upload."""
            from ..testing import demo_result
            from .schema import result_to_entry

            entry = result_to_entry(demo_result(),
                                    file_name="demo-codeswitching.wav",
                                    audio_url="")
            entry["id"] = "demo"
            entry["created_at"] = "2026-01-01T00:00:00Z"
            return JSONResponse(entry)

        @r.route("GET", "/api/history/{history_id}/export")
        def export_history(req: Request) -> Response:
            """Server-side export via the byte-compatible exporters — the
            reference renders these client-side (public app.js:1336); having
            them on the server too means programmatic clients get EAF/
            TextGrid/SRT/TXT/JSON without a browser."""
            from ..exporters import export_transcript

            entry = self.history.get(req.path_params["history_id"],
                                     self._user(req))
            if entry is None:
                raise HTTPError(404, "History entry not found.")
            fmt = req.query.get("format", "json").lower()
            kw = {}
            if fmt == "eaf" and req.query.get("words"):
                kw["include_words"] = True  # golden-style word tiers
            try:
                content = export_transcript(entry, fmt, **kw)
            except ValueError as e:
                raise HTTPError(400, str(e)) from None
            ctypes_map = {"eaf": "application/xml",
                          "json": "application/json"}
            return Response(content.encode("utf-8"), 200,
                            ctypes_map.get(fmt, "text/plain; charset=utf-8"))

        # ---- audio blobs ---------------------------------------------------

        @r.route("GET", "/api/audio/{history_id}")
        def get_audio(req: Request) -> Response:
            if not isinstance(self.history, SqliteHistory):
                raise HTTPError(404, "Audio not found.")
            blob = self.history.get_audio(req.path_params["history_id"],
                                          self._user(req))
            if blob is None:
                raise HTTPError(404, "Audio not found.")
            return Response(blob, 200, "application/octet-stream")

        # ---- auth ----------------------------------------------------------

        @r.route("POST", "/api/auth/register")
        def register(req: Request) -> Response:
            # Semantics of reference auth/register.js:22-120.
            try:
                body = req.json() or {}
            except json.JSONDecodeError:
                return JSONResponse({"error": "Invalid JSON body."}, 400)
            code = (body.get("access_code") or "").strip().lower()
            if code != auth_mod.access_code():
                return JSONResponse({"error": "Invalid access code."}, 403)
            email = (body.get("email") or "").strip().lower()
            password = body.get("password") or ""
            if not email or not auth_mod.valid_email(email):
                return JSONResponse({"error": "Valid email is required."}, 400)
            if len(password) < 8:
                return JSONResponse(
                    {"error": "Password must be at least 8 characters."}, 400)
            if not isinstance(self.history, SqliteHistory):
                return JSONResponse({"error": "Server misconfigured."}, 500)
            if self.history.get_user_by_email(email):
                return JSONResponse(
                    {"error": "An account with this email already exists."},
                    409)
            user = self.history.create_user(
                email, auth_mod.hash_password(password))
            token = auth_mod.create_jwt(
                {"sub": user["id"], "email": email}, self.jwt_secret)
            return JSONResponse({"token": token, "user": user}, 201)

        @r.route("POST", "/api/auth/login")
        def login(req: Request) -> Response:
            try:
                body = req.json() or {}
            except json.JSONDecodeError:
                return JSONResponse({"error": "Invalid JSON body."}, 400)
            email = (body.get("email") or "").strip().lower()
            password = body.get("password") or ""
            if not isinstance(self.history, SqliteHistory):
                return JSONResponse({"error": "Server misconfigured."}, 500)
            user = self.history.get_user_by_email(email)
            if not user or not auth_mod.verify_password(
                    password, user["password_hash"]):
                return JSONResponse({"error": "Invalid email or password."},
                                    401)
            token = auth_mod.create_jwt(
                {"sub": user["id"], "email": email}, self.jwt_secret)
            return JSONResponse({"token": token,
                                 "user": {"id": user["id"], "email": email}})

        @r.route("GET", "/api/auth/me")
        def me(req: Request) -> Response:
            token = auth_mod.get_bearer_token(req.headers)
            payload = auth_mod.verify_jwt(token, self.jwt_secret) if token else None
            if not payload or not payload.get("sub"):
                return JSONResponse({"error": "Invalid or expired token."}, 401)
            return JSONResponse({"user": {"id": payload["sub"],
                                          "email": payload.get("email")}})

    def _serve_file(self, root: Path, rel: str) -> Response:
        target = (root / rel).resolve()
        if not target.is_relative_to(root.resolve()) or not target.is_file():
            raise HTTPError(404, "Not Found")
        ctype = mimetypes.guess_type(str(target))[0] or "application/octet-stream"
        return Response(target.read_bytes(), 200, ctype)

    # -- lifecycle -----------------------------------------------------------

    def serve(self, host: str = "127.0.0.1", port: int = 8000):
        self.app.serve(host, port)

    def serve_background(self, host: str = "127.0.0.1", port: int = 0) -> int:
        return self.app.serve_background(host, port)

    def shutdown(self):
        self.app.shutdown()


def main():
    import argparse

    ap = argparse.ArgumentParser(
        description="OmniScribe server (PyTorch/CUDA engine)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--auth", action="store_true",
                    help="require JWT auth on /api routes")
    ap.add_argument("--memory", action="store_true",
                    help="in-memory history (the reference local server's "
                         "semantics, app.py:39-40) instead of SQLite")
    args = ap.parse_args()
    srv = OmniServer(base_dir=args.data_dir, auth_required=args.auth,
                     use_sqlite=not args.memory)

    # SIGTERM must be a CLEAN exit: python's default SIGTERM handling skips
    # atexit, where accelerator and temporary-file clean-up rides; `kill
    # <pid>` on this server exits like Ctrl-C does.
    import signal
    import sys as _sys

    def _term(_sig, _frm):
        try:
            srv.shutdown()
        except Exception:
            pass
        _sys.exit(0)

    signal.signal(signal.SIGTERM, _term)
    print(f"OmniScribe (PyTorch/CUDA) serving on "
          f"http://{args.host}:{args.port}")
    srv.serve(args.host, args.port)


if __name__ == "__main__":
    main()
