"""Transcript history store: SQLite + blob-dir audio storage.

Schema mirrors the reference's D1 migrations byte-for-byte
(reference migrations/0001_init.sql, 0002_add_session.sql, 0003_users.sql):
transcripts / segments (UNIQUE(transcript_id, sort_order)) / edits audit /
users, with user scoping. Audio blobs are stored under ``<dir>/audio/`` keyed
``audio/{id}.{ext}`` — the local equivalent of the reference's R2 bucket
(reference functions/api/_history.js:222-243). Segment inserts are batched
100 rows at a time like the reference (:98-117).

An in-memory mode (``MemoryHistory``) matches the local FastAPI server's
dict-based store (reference workflows/wav2elan_web/app.py:39-40, 67-73).

The PyTorch port's own copy of ``omnilingual_asr_tpu/serving/history.py``
(the port imports nothing of the JAX package); keep the two in step.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import uuid
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List, Optional

SCHEMA = """
CREATE TABLE IF NOT EXISTS transcripts (
  id TEXT PRIMARY KEY,
  file_name TEXT NOT NULL,
  created_at TEXT NOT NULL DEFAULT (datetime('now')),
  summary TEXT,
  detected_languages TEXT,
  audio_key TEXT,
  session_key TEXT,
  user_id TEXT REFERENCES users(id)
);
CREATE INDEX IF NOT EXISTS idx_transcripts_session ON transcripts(session_key);
CREATE INDEX IF NOT EXISTS idx_transcripts_user ON transcripts(user_id);

CREATE TABLE IF NOT EXISTS segments (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  transcript_id TEXT NOT NULL REFERENCES transcripts(id) ON DELETE CASCADE,
  sort_order INTEGER NOT NULL,
  speaker TEXT,
  content TEXT,
  start_time REAL NOT NULL DEFAULT 0,
  end_time REAL NOT NULL DEFAULT 0,
  language TEXT,
  language_code TEXT,
  languages TEXT,
  emotion TEXT DEFAULT 'neutral',
  translation TEXT,
  words TEXT,
  UNIQUE(transcript_id, sort_order)
);
CREATE INDEX IF NOT EXISTS idx_segments_transcript ON segments(transcript_id);

CREATE TABLE IF NOT EXISTS edits (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  transcript_id TEXT NOT NULL REFERENCES transcripts(id) ON DELETE CASCADE,
  segment_sort_order INTEGER,
  field TEXT NOT NULL,
  old_value TEXT,
  new_value TEXT,
  created_at TEXT NOT NULL DEFAULT (datetime('now'))
);
CREATE INDEX IF NOT EXISTS idx_edits_transcript ON edits(transcript_id);

CREATE TABLE IF NOT EXISTS users (
  id TEXT PRIMARY KEY,
  email TEXT UNIQUE NOT NULL COLLATE NOCASE,
  password_hash TEXT NOT NULL,
  created_at TEXT NOT NULL DEFAULT (datetime('now'))
);
"""

SEGMENT_BATCH = 100  # reference _history.js:98-117


def now_iso() -> str:
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def _segment_row_to_dict(row: sqlite3.Row) -> Dict[str, Any]:
    d: Dict[str, Any] = {
        "start": row["start_time"],
        "end": row["end_time"],
        "speaker": row["speaker"],
        "text": row["content"],
    }
    for k in ("language", "language_code", "emotion", "translation"):
        if row[k] is not None:
            d[k] = row[k]
    for k in ("languages", "words"):
        if row[k]:
            try:
                d[k] = json.loads(row[k])
            except json.JSONDecodeError:
                pass
    return d


class SqliteHistory:
    """User-scoped transcript CRUD + audio blobs + edit audit log."""

    def __init__(self, path: str | Path = ":memory:",
                 audio_dir: Optional[Path] = None):
        self._db_path = str(path)
        self._conn = sqlite3.connect(self._db_path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._conn.executescript(SCHEMA)
        self._lock = threading.Lock()
        self.audio_dir = Path(audio_dir) if audio_dir else None
        if self.audio_dir:
            (self.audio_dir / "audio").mkdir(parents=True, exist_ok=True)

    # -- users -----------------------------------------------------------

    def create_user(self, email: str, password_hash: str) -> Dict[str, str]:
        user_id = str(uuid.uuid4())
        with self._lock:
            self._conn.execute(
                "INSERT INTO users (id, email, password_hash) VALUES (?, ?, ?)",
                (user_id, email, password_hash))
            self._conn.commit()
        return {"id": user_id, "email": email}

    def get_user_by_email(self, email: str) -> Optional[Dict[str, Any]]:
        row = self._conn.execute(
            "SELECT * FROM users WHERE email = ?", (email,)).fetchone()
        return dict(row) if row else None

    def get_user(self, user_id: str) -> Optional[Dict[str, Any]]:
        row = self._conn.execute(
            "SELECT id, email, created_at FROM users WHERE id = ?",
            (user_id,)).fetchone()
        return dict(row) if row else None

    # -- transcripts -------------------------------------------------------

    def put(self, entry: Dict[str, Any],
            user_id: Optional[str] = None) -> Dict[str, Any]:
        """Insert a history entry; assigns id + created_at like the local
        server (reference app.py:67-73)."""
        history_id = entry.get("id") or uuid.uuid4().hex
        created = entry.get("created_at") or now_iso()
        segments = entry.get("segments", [])
        with self._lock:
            self._conn.execute(
                "INSERT INTO transcripts (id, file_name, created_at, summary,"
                " detected_languages, audio_key, user_id)"
                " VALUES (?, ?, ?, ?, ?, ?, ?)",
                (history_id, entry.get("file_name", ""), created,
                 entry.get("summary"),
                 json.dumps(entry["detected_languages"])
                 if entry.get("detected_languages") else None,
                 entry.get("audio_key"), user_id))
            self._insert_segments(history_id, segments)
            self._conn.commit()
        out = dict(entry)
        out["id"] = history_id
        out["created_at"] = created
        return out

    def _insert_segments(self, history_id: str, segments: List[dict]):
        rows = []
        for i, seg in enumerate(segments):
            rows.append((
                history_id, i, seg.get("speaker"), seg.get("text"),
                seg.get("start", 0.0), seg.get("end", 0.0),
                seg.get("language"), seg.get("language_code"),
                json.dumps(seg["languages"]) if seg.get("languages") else None,
                seg.get("emotion", "neutral"), seg.get("translation"),
                json.dumps(seg["words"]) if seg.get("words") else None,
            ))
        for b in range(0, len(rows), SEGMENT_BATCH):
            self._conn.executemany(
                "INSERT INTO segments (transcript_id, sort_order, speaker,"
                " content, start_time, end_time, language, language_code,"
                " languages, emotion, translation, words)"
                " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                rows[b:b + SEGMENT_BATCH])

    def list(self, user_id: Optional[str] = None) -> List[Dict[str, Any]]:
        q = ("SELECT id, file_name, created_at FROM transcripts"
             + (" WHERE user_id = ?" if user_id else "")
             + " ORDER BY created_at DESC, rowid DESC")
        rows = self._conn.execute(q, (user_id,) if user_id else ()).fetchall()
        return [dict(r) for r in rows]

    def get(self, history_id: str,
            user_id: Optional[str] = None) -> Optional[Dict[str, Any]]:
        q = "SELECT * FROM transcripts WHERE id = ?"
        args: tuple = (history_id,)
        if user_id:
            q += " AND user_id = ?"
            args = (history_id, user_id)
        row = self._conn.execute(q, args).fetchone()
        if not row:
            return None
        segs = self._conn.execute(
            "SELECT * FROM segments WHERE transcript_id = ? ORDER BY sort_order",
            (history_id,)).fetchall()
        entry: Dict[str, Any] = {
            "id": row["id"],
            "file_name": row["file_name"],
            "created_at": row["created_at"],
            "segments": [_segment_row_to_dict(s) for s in segs],
        }
        if row["summary"]:
            entry["summary"] = row["summary"]
        if row["detected_languages"]:
            entry["detected_languages"] = json.loads(row["detected_languages"])
        if row["audio_key"]:
            entry["audio_key"] = row["audio_key"]
            entry["audio_url"] = f"/api/audio/{row['id']}"
        return entry

    def update(self, history_id: str, payload: Dict[str, Any],
               user_id: Optional[str] = None) -> Optional[Dict[str, Any]]:
        """Update file_name and/or segments (reference app.py:445-455)."""
        existing = self.get(history_id, user_id)
        if existing is None:
            return None
        with self._lock:
            if "file_name" in payload:
                self._conn.execute(
                    "UPDATE transcripts SET file_name = ? WHERE id = ?",
                    (payload["file_name"], history_id))
            if "segments" in payload:
                self._conn.execute(
                    "DELETE FROM segments WHERE transcript_id = ?",
                    (history_id,))
                self._insert_segments(history_id, payload["segments"])
            self._conn.commit()
        return self.get(history_id, user_id)

    def delete(self, history_id: str, user_id: Optional[str] = None) -> bool:
        with self._lock:
            q = "DELETE FROM transcripts WHERE id = ?"
            args: tuple = (history_id,)
            if user_id:
                q += " AND user_id = ?"
                args = (history_id, user_id)
            cur = self._conn.execute(q, args)
            if cur.rowcount > 0:
                # Only cascade when the (user-scoped) transcript delete hit:
                # otherwise an authenticated user could wipe another user's
                # segments. sqlite3 ships with foreign_keys off, so the
                # schema's ON DELETE CASCADE never fires on its own.
                self._conn.execute(
                    "DELETE FROM segments WHERE transcript_id = ?",
                    (history_id,))
                self._conn.execute(
                    "DELETE FROM edits WHERE transcript_id = ?",
                    (history_id,))
            self._conn.commit()
            return cur.rowcount > 0

    # -- audio blobs (R2 equivalent) ---------------------------------------

    def store_audio(self, history_id: str, ext: str, content: bytes) -> str:
        """Store an audio blob keyed audio/{id}.{ext}
        (reference _history.js:222-230)."""
        if self.audio_dir is None:
            raise RuntimeError("history store has no audio_dir configured")
        key = f"audio/{history_id}{ext}"
        (self.audio_dir / key).write_bytes(content)
        with self._lock:
            self._conn.execute(
                "UPDATE transcripts SET audio_key = ? WHERE id = ?",
                (key, history_id))
            self._conn.commit()
        return key

    def get_audio(self, history_id: str,
                  user_id: Optional[str] = None) -> Optional[bytes]:
        entry = self.get(history_id, user_id)
        if not entry or "audio_key" not in entry or self.audio_dir is None:
            return None
        path = self.audio_dir / entry["audio_key"]
        return path.read_bytes() if path.exists() else None

    # -- edit audit log ----------------------------------------------------

    def log_edit(self, history_id: str, field: str, old_value: Any,
                 new_value: Any, segment_sort_order: Optional[int] = None):
        """Audit-log an edit (reference _history.js:248-255)."""
        with self._lock:
            self._conn.execute(
                "INSERT INTO edits (transcript_id, segment_sort_order, field,"
                " old_value, new_value) VALUES (?, ?, ?, ?, ?)",
                (history_id, segment_sort_order, field,
                 json.dumps(old_value), json.dumps(new_value)))
            self._conn.commit()

    def list_edits(self, history_id: str) -> List[Dict[str, Any]]:
        rows = self._conn.execute(
            "SELECT * FROM edits WHERE transcript_id = ? ORDER BY id",
            (history_id,)).fetchall()
        return [dict(r) for r in rows]


class MemoryHistory:
    """Dict-backed store with the local server's exact semantics
    (reference app.py:39-40, 67-73, 420-460)."""

    def __init__(self):
        self.entries: Dict[str, Dict[str, Any]] = {}
        self.order: List[str] = []
        self._lock = threading.Lock()

    def put(self, entry: Dict[str, Any], user_id=None) -> Dict[str, Any]:
        history_id = uuid.uuid4().hex
        entry = dict(entry)
        entry["id"] = history_id
        entry["created_at"] = now_iso()
        with self._lock:
            self.entries[history_id] = entry
            self.order.insert(0, history_id)
        return entry

    def list(self, user_id=None) -> List[Dict[str, Any]]:
        return [
            {"id": hid,
             "file_name": self.entries[hid]["file_name"],
             "created_at": self.entries[hid]["created_at"]}
            for hid in self.order if hid in self.entries
        ]

    def get(self, history_id: str, user_id=None) -> Optional[Dict[str, Any]]:
        return self.entries.get(history_id)

    def update(self, history_id: str, payload: Dict[str, Any],
               user_id=None) -> Optional[Dict[str, Any]]:
        if history_id not in self.entries:
            return None
        updated = self.entries[history_id]
        if "file_name" in payload:
            updated["file_name"] = payload["file_name"]
        if "segments" in payload:
            updated["segments"] = payload["segments"]
        self.entries[history_id] = updated
        return updated

    def delete(self, history_id: str, user_id=None) -> bool:
        with self._lock:
            self.entries.pop(history_id, None)
            if history_id in self.order:
                self.order.remove(history_id)
        return True
