"""Auth subsystem: PBKDF2 password hashing + HS256 JWT.

Wire/storage-compatible with the reference's Cloudflare Workers auth
(reference functions/api/_auth.js): PBKDF2-SHA256, 100,000 iterations,
256-bit keys, stored as "salt_hex:hash_hex" (:6-98); HS256 JWT with 30-day
expiry and {sub, email, iat, exp} claims (:102-165); JWT-secret fallback
derived from GEMINI_API_KEY exactly as the reference does (:179-185), with a
locally-persisted random secret as the final fallback (the reference has no
offline mode; we must).

The PyTorch port's own copy of ``omnilingual_asr_tpu/serving/auth.py``
(the port imports nothing of the JAX package); keep the two in step.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import re
import secrets
import time
from pathlib import Path
from typing import Optional

PBKDF2_ITERATIONS = 100_000
KEY_LENGTH_BYTES = 32  # 256 bits
JWT_EXPIRY_SECONDS = 30 * 24 * 60 * 60  # 30 days
EMAIL_RE = re.compile(r"^[^\s@]+@[^\s@]+\.[^\s@]+$")
# Server-side registration gate (reference auth/register.js:54-58); the
# value is configurable here where the reference hardcodes it.
DEFAULT_ACCESS_CODE = "sesquip"


def hash_password(password: str) -> str:
    salt = secrets.token_bytes(16)
    digest = hashlib.pbkdf2_hmac("sha256", password.encode(), salt,
                                 PBKDF2_ITERATIONS, dklen=KEY_LENGTH_BYTES)
    return f"{salt.hex()}:{digest.hex()}"


def verify_password(password: str, stored: str) -> bool:
    try:
        salt_hex, expected_hex = stored.split(":")
    except ValueError:
        return False
    digest = hashlib.pbkdf2_hmac("sha256", password.encode(),
                                 bytes.fromhex(salt_hex),
                                 PBKDF2_ITERATIONS, dklen=KEY_LENGTH_BYTES)
    return hmac.compare_digest(digest.hex(), expected_hex)


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def create_jwt(payload: dict, secret: str,
               now: Optional[int] = None) -> str:
    now = int(time.time()) if now is None else now
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    body = _b64url(json.dumps(
        {**payload, "iat": now, "exp": now + JWT_EXPIRY_SECONDS}).encode())
    data = f"{header}.{body}"
    sig = hmac.new(secret.encode(), data.encode(), hashlib.sha256).digest()
    return f"{data}.{_b64url(sig)}"


def verify_jwt(token: str, secret: str,
               now: Optional[int] = None) -> Optional[dict]:
    parts = token.split(".")
    if len(parts) != 3:
        return None
    header, body, sig = parts
    data = f"{header}.{body}"
    want = hmac.new(secret.encode(), data.encode(), hashlib.sha256).digest()
    try:
        got = _b64url_decode(sig)
    except Exception:
        return None
    if not hmac.compare_digest(want, got):
        return None
    try:
        payload = json.loads(_b64url_decode(body))
    except Exception:
        return None
    now = int(time.time()) if now is None else now
    if payload.get("exp") and payload["exp"] < now:
        return None
    return payload


def get_bearer_token(headers: dict) -> Optional[str]:
    auth = headers.get("authorization", "")
    if auth.startswith("Bearer "):
        return auth[7:].strip()
    return None


def get_jwt_secret(state_dir: Optional[Path] = None) -> str:
    """Resolve the signing secret with the reference's fallback chain
    (JWT_SECRET -> derived from GEMINI_API_KEY, _auth.js:179-185), extended
    with a persisted random secret so a fully-local deployment works with no
    env configuration at all."""
    if os.getenv("JWT_SECRET"):
        return os.environ["JWT_SECRET"]
    if os.getenv("GEMINI_API_KEY"):
        return f"omni-jwt-{os.environ['GEMINI_API_KEY']}"
    state_dir = state_dir or Path.home() / ".omniasr"
    state_dir.mkdir(parents=True, exist_ok=True)
    secret_file = state_dir / "jwt_secret"
    if secret_file.exists():
        return secret_file.read_text().strip()
    secret = secrets.token_hex(32)
    secret_file.write_text(secret)
    try:
        secret_file.chmod(0o600)
    except OSError:
        pass
    return secret


def access_code() -> str:
    return os.getenv("OMNIASR_ACCESS_CODE", DEFAULT_ACCESS_CODE)


def valid_email(email: str) -> bool:
    return bool(EMAIL_RE.match(email))
