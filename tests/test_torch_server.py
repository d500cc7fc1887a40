"""PyTorch port: the HTTP server (``omnilingual_asr_torch.serving``) against
the JAX package's.

The JAX server's HTTP scenarios (``tests/test_server.py``: sync, stream,
batch, zip, history CRUD and audit, auth flow and scoping, export, demo,
audio blobs, memory mode, session keys, parallel SSE, the live route) run
against both servers, each in front of its own package's ``FakeEngine``.
Each scenario's checks hold on either server (``test_scenario``), and the
two servers' status codes and bodies are equal with ids and timestamps
masked (``test_scenario_parity``): history and user ids, upload names,
``created_at``, JWTs and the EAF DATE, and nothing else.

Then the port's server in front of the port's CPU engine with the release
weights and decoders answers ``/api/transcribe`` for the golden file, held
to ``golden_decoders.json``; the live route answers 501 in front of the
real engine; and the default engine raises without a CUDA device.
"""

from __future__ import annotations

import http.client
import importlib
import io
import json
import re
import sqlite3
import threading
import wave
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from omnilingual_asr_torch import testing as golden

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
RELEASE = REPO / "checkpoints" / "release"
PACKAGES = {"jax": "omnilingual_asr_tpu", "port": "omnilingual_asr_torch"}
FORMATS = ("eaf", "textgrid", "srt", "txt", "json")


def make_wav_bytes(seconds=1.0, sr=8000):
    buf = io.BytesIO()
    x = (np.sin(np.arange(int(seconds * sr)) * 0.1) * 10000).astype("<i2")
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x.tobytes())
    return buf.getvalue()


def multipart(fields: dict, files: list):
    """files: [(name, filename, bytes)]"""
    boundary = "testboundary123"
    out = io.BytesIO()
    for k, v in fields.items():
        out.write(f"--{boundary}\r\nContent-Disposition: form-data; "
                  f"name=\"{k}\"\r\n\r\n{v}\r\n".encode())
    for name, fname, data in files:
        out.write(f"--{boundary}\r\nContent-Disposition: form-data; "
                  f"name=\"{name}\"; filename=\"{fname}\"\r\n"
                  f"Content-Type: application/octet-stream\r\n\r\n".encode())
        out.write(data)
        out.write(b"\r\n")
    out.write(f"--{boundary}--\r\n".encode())
    return out.getvalue(), f"multipart/form-data; boundary={boundary}"


class Client:
    def __init__(self, port, token=None):
        self.port = port
        self.token = token

    def request(self, method, path, body=None, content_type=None, raw=False,
                headers=None, timeout=60):
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=timeout)
        headers = dict(headers or {})
        if content_type:
            headers["Content-Type"] = content_type
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        if raw:
            return resp.status, data
        return resp.status, (json.loads(data) if data else None)

    def sse(self, method, path, body, content_type, timeout=60):
        status, data = self.request(method, path, body, content_type,
                                    raw=True, timeout=timeout)
        events = []
        for block in data.decode().split("\n\n"):
            if not block.strip():
                continue
            ev = {}
            for line in block.splitlines():
                k, _, v = line.partition(": ")
                ev[k] = v
            if "event" in ev:
                events.append((ev["event"], json.loads(ev["data"])))
        return status, events


# ---------------------------------------------------------------------------
# Masking of ids and clocks
# ---------------------------------------------------------------------------

_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                   r"[0-9a-f]{12}|[0-9a-f]{32}")
_TIME = re.compile(r"\d{4}-\d\d-\d\d[T ]\d\d:\d\d:\d\d(?:\.\d+)?Z?")
_MASKED_KEYS = {"id", "created_at", "token"}


def mask(x):
    """``x`` with ids and timestamps replaced: the values of the keys in
    ``_MASKED_KEYS``, and uuids and ISO times inside strings."""
    if isinstance(x, dict):
        return {k: ("<masked>" if k in _MASKED_KEYS and v is not None
                    else mask(v)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [mask(v) for v in x]
    if isinstance(x, bytes):
        try:
            return mask(x.decode("utf-8"))
        except UnicodeDecodeError:
            return x
    if isinstance(x, str):
        return _TIME.sub("<time>", _UUID.sub("<id>", x))
    return x


class Server:
    """One package's ``OmniServer`` in front of its own ``FakeEngine``;
    ``log`` keeps every (label, status, masked body) it answered."""

    def __init__(self, pkg: str, base_dir: Path, *, auth: bool = False,
                 sqlite: bool = True, delay_s: float = 0.0):
        app = importlib.import_module(f"{PACKAGES[pkg]}.serving.app")
        testing = importlib.import_module(f"{PACKAGES[pkg]}.testing")
        self.pkg = pkg
        self.base_dir = Path(base_dir)
        self.srv = app.OmniServer(engine=testing.FakeEngine(delay_s=delay_s),
                                  base_dir=self.base_dir, auth_required=auth,
                                  use_sqlite=sqlite)
        self.client = Client(self.srv.serve_background())
        self.log = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()

    def call(self, label, method, path, body=None, ctype=None, raw=False,
             token=None, headers=None):
        c = Client(self.client.port, token=token)
        status, out = c.request(method, path, body, ctype, raw=raw,
                                headers=headers)
        self.log.append((label, status, mask(out)))
        return status, out

    def sse(self, label, path, body, ctype, token=None):
        status, events = Client(self.client.port, token=token).sse(
            "POST", path, body, ctype)
        self.log.append((label, status, mask(events)))
        return status, events


def _upload(name="a.wav", field="file", data=None, fields=None):
    return multipart(fields or {},
                     [(field, name, data if data is not None
                       else make_wav_bytes())])


# ---------------------------------------------------------------------------
# The scenarios of tests/test_server.py, on either server
# ---------------------------------------------------------------------------

def scenario_sync(s: Server):
    status, entry = s.call("sync", "POST", "/api/transcribe", *_upload())
    assert status == 200
    assert entry["file_name"] == "a.wav" and entry["id"]
    assert len(entry["segments"]) == 2
    seg = entry["segments"][0]
    assert seg["speaker"] == "Speaker 1"
    assert seg["languages"][0]["code"] == "lis"
    assert "summary" in entry and "detected_languages" in entry
    status, err = s.call("zip", "POST", "/api/transcribe",
                         *_upload("a.zip", data=b"PK\x03\x04junk"))
    assert status == 400 and "batch" in err["detail"]
    status, err = s.call("txt", "POST", "/api/transcribe",
                         *_upload("a.txt", data=b"hi"))
    assert status == 400 and err["detail"] == "Unsupported file type."
    status, err = s.call("no file", "POST", "/api/transcribe",
                         *multipart({"x": "1"}, []))
    assert status == 400


def scenario_stream(s: Server):
    status, events = s.sse("stream", "/api/transcribe-stream",
                           *_upload("b.wav", fields={"language": "en"}))
    assert status == 200
    assert [e for e, _ in events][-1] == "result"
    steps = [d["step"] for e, d in events if e == "progress"]
    assert steps == ["uploading", "transcribing", "processing", "done"]
    assert events[-1][1]["file_name"] == "b.wav" and events[-1][1]["id"]


def _batch_events(events):
    """Batch progress in a canonical order: files run in parallel, so
    their events interleave at random; each file's own order is kept."""
    prog = [d for e, d in events if e == "progress"]
    prog.sort(key=lambda d: d["file_index"])
    return prog + [d for e, d in events if e != "progress"]


def scenario_batch(s: Server):
    body, ctype = multipart({}, [("files", "x.wav", make_wav_bytes()),
                                 ("files", "y.wav", make_wav_bytes())])
    status, events = Client(s.client.port).sse(
        "POST", "/api/transcribe-batch-stream", body, ctype)
    s.log.append(("batch", status, mask(_batch_events(events))))
    assert status == 200
    result = events[-1][1]
    assert [r["file_name"] for r in result["results"]] == ["x.wav", "y.wav"]
    prog = [d for e, d in events if e == "progress"]
    assert all("file_index" in p and p["file_count"] == 2 for p in prog)
    status, err = s.call("batch empty", "POST", "/api/transcribe-batch-stream",
                         *multipart({}, [("files", "n.txt", b"x")]))
    assert status == 400


def scenario_zip(s: Server):
    zbuf = io.BytesIO()
    with zipfile.ZipFile(zbuf, "w") as z:
        z.writestr("one.wav", make_wav_bytes())
        z.writestr("sub/two.wav", make_wav_bytes())
        z.writestr("../evil.wav", make_wav_bytes())  # traversal: skipped
        z.writestr("notes.txt", b"skip me")
    body, ctype = multipart({}, [("files", "batch.zip", zbuf.getvalue())])
    status, events = Client(s.client.port).sse(
        "POST", "/api/transcribe-batch-stream", body, ctype)
    s.log.append(("zip", status, mask(_batch_events(events))))
    assert status == 200
    names = sorted(r["file_name"] for r in events[-1][1]["results"])
    assert names == ["one.wav", "sub/two.wav"]
    assert not (s.base_dir / "uploads" / "evil.wav").exists()


def scenario_history(s: Server):
    _, entry = s.call("post", "POST", "/api/transcribe", *_upload("h.wav"))
    hid = entry["id"]
    status, items = s.call("list", "GET", "/api/history")
    assert status == 200 and any(i["id"] == hid for i in items)
    assert set(items[0]) == {"id", "file_name", "created_at"}
    status, got = s.call("get", "GET", f"/api/history/{hid}")
    assert status == 200 and got["file_name"] == "h.wav"
    assert len(got["segments"]) == 2
    segs = got["segments"]
    segs[0]["text"] = "edited text"
    status, updated = s.call(
        "put", "PUT", f"/api/history/{hid}",
        json.dumps({"file_name": "renamed.wav", "segments": segs}),
        "application/json")
    assert status == 200 and updated["file_name"] == "renamed.wav"
    status, got = s.call("get edited", "GET", f"/api/history/{hid}")
    assert got["segments"][0]["text"] == "edited text"
    # The edits audit (reference migrations/0001:32-42): one row a field.
    with sqlite3.connect(s.base_dir / "history.db") as db:
        rows = db.execute("SELECT field, old_value, new_value FROM "
                          "edits WHERE transcript_id = ? ORDER BY rowid",
                          (hid,)).fetchall()
    s.log.append(("audit", 0, mask(rows)))
    assert [r[0] for r in rows] == ["file_name", "segments"]
    assert rows[0][1:] == ('"h.wav"', '"renamed.wav"')
    status, out = s.call("delete", "DELETE", f"/api/history/{hid}")
    assert status == 200 and out == {"ok": True}
    status, _ = s.call("get deleted", "GET", f"/api/history/{hid}")
    assert status == 404
    status, err = s.call("missing", "GET", "/api/history/nope")
    assert status == 404 and err["detail"] == "History entry not found."
    status, _ = s.call("put missing", "PUT", "/api/history/nope",
                       json.dumps({"file_name": "x"}), "application/json")
    assert status == 404
    status, err = s.call("delete missing", "DELETE", "/api/history/nope")
    assert status == 404 and err == {"error": "Not found"}


def _register(s: Server, label, email, password="longenough",
              code="sesquip"):
    return s.call(label, "POST", "/api/auth/register",
                  json.dumps({"access_code": code, "email": email,
                              "password": password}), "application/json")


def scenario_auth(s: Server):
    status, err = s.call("no token", "GET", "/api/history")
    assert status == 401 and err["error"] == "Authentication required."
    status, _ = s.call("bad token", "GET", "/api/history", token="x.y.z")
    assert status == 401
    status, _ = _register(s, "bad code", "a@b.co", code="wrong")
    assert status == 403
    status, out = _register(s, "register", "a@b.co")
    assert status == 201 and out["user"]["email"] == "a@b.co"
    token = out["token"]
    status, _ = _register(s, "duplicate", "a@b.co")
    assert status == 409
    status, _ = _register(s, "short password", "x@y.co", password="short")
    assert status == 400
    status, _ = _register(s, "bad email", "bademail")
    assert status == 400
    status, _ = s.call("bad json", "POST", "/api/auth/register", "{nope",
                       "application/json")
    assert status == 400
    status, out = s.call("login", "POST", "/api/auth/login",
                         json.dumps({"email": "a@b.co",
                                     "password": "longenough"}),
                         "application/json")
    assert status == 200 and out["token"]
    status, _ = s.call("bad login", "POST", "/api/auth/login",
                       json.dumps({"email": "a@b.co",
                                   "password": "wrongwrong"}),
                       "application/json")
    assert status == 401
    status, items = s.call("history", "GET", "/api/history", token=token)
    assert status == 200 and items == []
    status, me = s.call("me", "GET", "/api/auth/me", token=token)
    assert status == 200 and me["user"]["email"] == "a@b.co"


def scenario_auth_scoping(s: Server):
    _, a = _register(s, "register a", "ua@s.co")
    _, b = _register(s, "register b", "ub@s.co")
    ta, tb = a["token"], b["token"]
    _, entry = s.call("a posts", "POST", "/api/transcribe",
                      *_upload("mine.wav"), token=ta)
    hid = entry["id"]
    status, _ = s.call("b reads", "GET", f"/api/history/{hid}", token=tb)
    assert status == 404
    status, _ = s.call("a reads", "GET", f"/api/history/{hid}", token=ta)
    assert status == 200
    status, _ = s.call("b deletes", "DELETE", f"/api/history/{hid}",
                       token=tb)
    assert status == 404
    status, mine = s.call("a still has it", "GET", f"/api/history/{hid}",
                          token=ta)
    assert status == 200 and len(mine["segments"]) == 2
    status, _ = s.call("b audio", "GET", f"/api/audio/{hid}", token=tb)
    assert status == 404
    status, _ = s.call("a deletes", "DELETE", f"/api/history/{hid}",
                       token=ta)
    assert status == 200
    status, _ = s.call("gone", "GET", f"/api/history/{hid}", token=ta)
    assert status == 404


def scenario_export(s: Server):
    _, entry = s.call("post", "POST", "/api/transcribe", *_upload("ex.wav"))
    hid = entry["id"]
    for fmt in FORMATS:
        status, body = s.call(fmt, "GET",
                              f"/api/history/{hid}/export?format={fmt}",
                              raw=True)
        assert status == 200 and body
    status, eaf = s.call("eaf words", "GET",
                         f"/api/history/{hid}/export?format=eaf&words=1",
                         raw=True)
    assert status == 200 and b"_words" in eaf
    status, _ = s.call("nope", "GET",
                       f"/api/history/{hid}/export?format=nope")
    assert status == 400
    status, _ = s.call("missing", "GET", "/api/history/nope/export")
    assert status == 404


def scenario_static(s: Server):
    status, html = s.call("index", "GET", "/", raw=True)
    assert status == 200 and b"OmniScribe" in html
    for name in ("app.js", "style.css", "index.html"):
        status, body = s.call(name, "GET", f"/static/{name}", raw=True)
        assert status == 200 and body
    status, body = s.call("shell", "GET", "/wav2elan", raw=True)
    assert status == 200 and b'window.OMNI_SHELL="wav2elan"' in body
    status, _ = s.call("traversal", "GET", "/static/..%2F..%2Fapp.py")
    assert status == 404
    status, _ = s.call("unknown route", "GET", "/api/nothing")
    assert status == 404


def scenario_demo(s: Server):
    status, demo = s.call("demo", "GET", "/api/demo")
    assert status == 200 and demo["id"] == "demo"
    assert len(demo["segments"]) == 2
    assert demo["segments"][0]["languages"][0]["code"] == "lis"


def scenario_live(s: Server):
    status, events = s.sse("live", "/api/transcribe-stream-live",
                           *_upload("live.wav"))
    assert status == 200
    kinds = [e for e, _ in events]
    assert kinds[0] == "progress" and kinds[-1] == "result"
    total = sum(len(d["segments"]) for e, d in events if e == "segments")
    assert total == 2
    steps = [d["step"] for e, d in events if e == "progress"]
    assert steps == ["uploading", "transcribing", "processing", "done"]


def scenario_audio(s: Server):
    wav = make_wav_bytes()
    _, entry = s.call("post", "POST", "/api/transcribe",
                      *_upload("blob.wav", data=wav))
    status, blob = Client(s.client.port).request(
        "GET", f"/api/audio/{entry['id']}", raw=True)
    s.log.append(("blob", status, blob))
    assert status == 200 and blob == wav
    _, got = s.call("get", "GET", f"/api/history/{entry['id']}")
    assert got.get("audio_key", "").startswith("audio/")
    status, _ = s.call("upload url", "GET", entry["audio_url"], raw=True)
    assert status == 200
    status, _ = s.call("missing blob", "GET", "/api/audio/nope")
    assert status == 404


def scenario_session_keys(s: Server):
    status, entry = s.call("post", "POST", "/api/transcribe",
                           *_upload("w2e.wav"),
                           headers={"x-session-key": "AbCd12345678"})
    assert status == 200
    status, mine = s.call("mine", "GET", "/api/history",
                          headers={"x-session-key": "AbCd12345678"})
    assert status == 200 and any(e["id"] == entry["id"] for e in mine)
    status, theirs = s.call("theirs", "GET", "/api/history",
                            headers={"x-session-key": "Zz9876543210"})
    assert status == 200
    assert not any(e["id"] == entry["id"] for e in theirs)
    status, out = s.call("invalid", "GET", "/api/history",
                         headers={"x-session-key": "../etc/passwd"})
    assert status == 200 and isinstance(out, list)


def scenario_memory(s: Server):
    """In-memory history: the reference local server's semantics (one
    global history, no audio blobs, no accounts)."""
    _, entry = s.call("post", "POST", "/api/transcribe", *_upload("m.wav"))
    status, items = s.call("list", "GET", "/api/history",
                           headers={"x-session-key": "AbCd12345678"})
    assert status == 200 and items[0]["id"] == entry["id"]
    status, _ = s.call("audio", "GET", f"/api/audio/{entry['id']}")
    assert status == 404
    status, out = _register(s, "register", "a@b.co")
    assert status == 500 and out == {"error": "Server misconfigured."}
    status, _ = s.call("delete", "DELETE", f"/api/history/{entry['id']}")
    assert status == 200


def scenario_parallel_sse(s: Server):
    """Three simultaneous SSE transcriptions do not interleave state."""
    results = {}

    def run(name):
        results[name] = Client(s.client.port).sse(
            "POST", "/api/transcribe-stream", *_upload(f"{name}.wav"))

    threads = [threading.Thread(target=run, args=(n,)) for n in "abc"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert set(results) == {"a", "b", "c"}
    for name in "abc":
        status, events = results[name]
        s.log.append((f"parallel {name}", status, mask(events)))
        assert status == 200
        assert events[-1][1]["file_name"] == f"{name}.wav"
        for _, d in events[:-1]:
            assert d["file_name"] == f"{name}.wav"


SCENARIOS = {
    "sync": (scenario_sync, {}),
    "stream": (scenario_stream, {}),
    "batch": (scenario_batch, {}),
    "zip": (scenario_zip, {}),
    "history_crud_audit": (scenario_history, {}),
    "auth_flow": (scenario_auth, {"auth": True}),
    "auth_scoping": (scenario_auth_scoping, {"auth": True}),
    "export": (scenario_export, {}),
    "static": (scenario_static, {}),
    "demo": (scenario_demo, {}),
    "live": (scenario_live, {}),
    "audio_blobs": (scenario_audio, {}),
    "memory_mode": (scenario_sync, {"sqlite": False}),
    "memory_mode_history": (scenario_memory, {"sqlite": False}),
    "session_keys": (scenario_session_keys, {}),
    "parallel_sse": (scenario_parallel_sse, {"delay_s": 0.3}),
}


def _run(name: str, pkg: str, base_dir: Path):
    fn, kw = SCENARIOS[name]
    with Server(pkg, base_dir, **kw) as s:
        fn(s)
    return s.log


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario(name, pkg, tmp_path):
    assert _run(name, pkg, tmp_path)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_parity(name, tmp_path):
    """Both servers answer the scenario with equal status codes and
    bodies, ids and timestamps masked."""
    want = _run(name, "jax", tmp_path / "jax")
    got = _run(name, "port", tmp_path / "port")
    assert [x[:2] for x in got] == [x[:2] for x in want]
    for g, w in zip(got, want):
        assert g == w, g[0]


# ---------------------------------------------------------------------------
# Units the server is built from
# ---------------------------------------------------------------------------

def test_auth_primitives_interoperate():
    """Hashes and tokens of one package verify in the other; a token of the
    same claims, secret and clock is the same string."""
    from omnilingual_asr_torch.serving import auth as port_auth
    from omnilingual_asr_tpu.serving import auth as jax_auth

    for a, b in ((port_auth, jax_auth), (jax_auth, port_auth)):
        h = a.hash_password("s3cretpass")
        salt, digest = h.split(":")
        assert len(salt) == 32 and len(digest) == 64
        assert b.verify_password("s3cretpass", h)
        assert not b.verify_password("wrong", h)
    claims = {"sub": "u1", "email": "e@x.co"}
    tok = port_auth.create_jwt(claims, "secret", now=1000)
    assert tok == jax_auth.create_jwt(claims, "secret", now=1000)
    payload = jax_auth.verify_jwt(tok, "secret", now=1001)
    assert payload == port_auth.verify_jwt(tok, "secret", now=1001)
    assert payload["exp"] == 1000 + port_auth.JWT_EXPIRY_SECONDS
    assert port_auth.verify_jwt(tok, "wrong-secret", now=1001) is None
    assert port_auth.verify_jwt(tok, "secret", now=payload["exp"] + 1) is None
    assert port_auth.access_code() == jax_auth.access_code()


def test_jwt_secret_persists_like_jax(tmp_path, monkeypatch):
    from omnilingual_asr_torch.serving import auth as port_auth
    from omnilingual_asr_tpu.serving import auth as jax_auth

    for var in ("JWT_SECRET", "GEMINI_API_KEY"):
        monkeypatch.delenv(var, raising=False)
    s1 = port_auth.get_jwt_secret(tmp_path)
    assert s1 and port_auth.get_jwt_secret(tmp_path) == s1
    assert jax_auth.get_jwt_secret(tmp_path) == s1
    monkeypatch.setenv("GEMINI_API_KEY", "k")
    assert port_auth.get_jwt_secret(tmp_path / "x") == \
        jax_auth.get_jwt_secret(tmp_path / "y")


def test_schema_without_optional_fields_equals_jax():
    from omnilingual_asr_torch.serving.schema import result_to_entry
    from omnilingual_asr_torch.types import (TranscriptSegment,
                                             TranscriptionResult)
    from omnilingual_asr_tpu.serving import schema as jax_schema
    from omnilingual_asr_tpu import types as jax_types

    seg = dict(start=0, end=1, speaker="Speaker 1", text="x")
    got = result_to_entry(
        TranscriptionResult(segments=[TranscriptSegment(**seg)]),
        file_name="f.wav", audio_url="/u")
    want = jax_schema.result_to_entry(
        jax_types.TranscriptionResult(
            segments=[jax_types.TranscriptSegment(**seg)]),
        file_name="f.wav", audio_url="/u")
    assert got == want
    assert "summary" not in got and "detected_languages" not in got
    assert got["segments"][0]["words"] == []


def test_host_helpers_equal_jax():
    """The host helpers the server reaches: timestamps, progress steps,
    speaker names, the demo result."""
    from omnilingual_asr_torch import types as pt
    from omnilingual_asr_torch.diarization.cluster import speaker_names
    from omnilingual_asr_tpu import testing as jax_testing
    from omnilingual_asr_tpu import types as jt
    from omnilingual_asr_tpu.diarization.cluster import \
        speaker_names as jax_speaker_names

    assert pt.PROGRESS_STEPS == jt.PROGRESS_STEPS
    for ts in ("", "01:30", "1:02:03.5", "42.25", "x:y", "1:2:3:4", None):
        assert pt.parse_timestamp(ts) == jt.parse_timestamp(ts)
    for sec in (0.0, 59.4, 59.6, 3599.5, 3725.2, -3.0):
        assert pt.format_timestamp(sec) == jt.format_timestamp(sec)
    labels = np.array([0, 2, 1, 0])
    assert speaker_names(labels) == jax_speaker_names(labels)
    assert golden.demo_result().to_dict() == \
        pt.TranscriptionResult(**vars(jax_testing.demo_result())).to_dict()


def test_fake_engine_retries_as_jax(tmp_path):
    from omnilingual_asr_tpu.testing import FakeEngine as JaxFake

    for cls in (golden.FakeEngine, JaxFake):
        eng = cls(fail_times=2)
        steps = []
        res = eng.transcribe_with_retry(
            tmp_path / "a.wav", progress_callback=lambda s, i: steps.append(i))
        assert res.segments and steps == [0, 1, 2, 3]
        assert len(eng.calls) == 3
        with pytest.raises(RuntimeError, match="after 2 attempts"):
            cls(fail_times=5).transcribe_with_retry("x.wav", max_retries=2)


# ---------------------------------------------------------------------------
# The port's server in front of the port's engine
# ---------------------------------------------------------------------------

def test_default_engine_needs_cuda(tmp_path):
    """With no engine given the server builds the port's engine, which
    runs on the card: without one it raises, and a request answers 500."""
    from omnilingual_asr_torch.serving.app import OmniServer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    srv = OmniServer(base_dir=tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srv.engine()
    port = srv.serve_background()
    try:
        status, err = Client(port).request("POST", "/api/transcribe",
                                           *_upload())
    finally:
        srv.shutdown()
    assert status == 500 and "no CUDA device" in err["detail"]


@pytest.fixture(scope="module")
def release_server(tmp_path_factory):
    """The port's server in front of the port's CPU engine with the
    release ASR, x-vector, translator and summarizer weights."""
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.engine import TranscriptionEngine
    from omnilingual_asr_torch.serving.app import OmniServer

    cfg = PipelineConfig.from_json((RELEASE / "config.json").read_text(),
                                   checkpoint_path=str(RELEASE / "asr.npz"))

    def factory():
        return TranscriptionEngine(
            config=cfg, device="cpu",
            xvector_path=str(RELEASE / "xvector.npz"),
            translator_path=str(RELEASE / "translator.npz"),
            summarizer_path=str(RELEASE / "summarizer.npz"))

    srv = OmniServer(engine_factory=factory,
                     base_dir=tmp_path_factory.mktemp("release_srv"))
    port = srv.serve_background()
    yield srv, Client(port)
    srv.shutdown()


def test_release_engine_answers_golden(release_server):
    """``/api/transcribe`` on the golden file through the port's CPU
    engine: the entry is held to ``golden_decoders.json`` (translations
    and the neural summary exact)."""
    srv, client = release_server
    body, ctype = multipart({}, [("file", "golden.wav",
                                  golden.GOLDEN_WAV.read_bytes())])
    status, entry = client.request("POST", "/api/transcribe", body, ctype,
                                   timeout=600)
    assert status == 200, entry
    stored = golden.load_golden_decoders()
    assert golden.result_mismatches(stored["result"], entry,
                                    tone_mass=stored["tone_mass"]) == []
    assert entry["summary"] == stored["result"]["summary"]
    assert [s.get("translation") for s in entry["segments"]] == \
        [s["translation"] for s in stored["result"]["segments"]]
    status, got = client.request("GET", f"/api/history/{entry['id']}")
    assert status == 200 and got["segments"] == entry["segments"]
    status, blob = client.request("GET", f"/api/audio/{entry['id']}",
                                  raw=True)
    assert blob == golden.GOLDEN_WAV.read_bytes()


def test_release_engine_live_route_is_501(release_server):
    """The port's engine has no ``transcribe_streaming`` (A9), so the live
    route answers 501, as the JAX server does for such an engine."""
    srv, client = release_server
    assert not hasattr(srv.engine(), "transcribe_streaming")
    status, err = client.request("POST", "/api/transcribe-stream-live",
                                 *_upload("live.wav"))
    assert status == 501
    assert err == {"detail": "Engine does not support streaming."}
