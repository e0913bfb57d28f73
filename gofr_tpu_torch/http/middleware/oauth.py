"""OAuth / JWT middleware (reference ``http/middleware/oauth.go:22-194``).

* :class:`JWKSProvider` refreshes a JWKS endpoint on a background daemon
  thread and caches RSA public keys by ``kid`` (reference
  ``oauth.go:53-86,94-140``); a dead endpoint is logged and survived;
* the middleware parses ``Authorization: Bearer`` JWTs (RS256, or HS256
  through ``hmac`` for shared-secret setups), checks the signature and
  ``exp``, and puts the claims in the request context under
  ``"JWTClaims"`` (reference ``oauth.go:143-194``).

The port's copy of ``gofr_tpu/http/middleware/oauth.py``, with one
difference of means: the reference checks RS256 with the
``cryptography`` package, which the port does not import. A key here is
its integers ``(n, e)`` and :func:`rs256_verify` checks
RSASSA-PKCS1-v1_5 with SHA-256 (RFC 8017 §8.2.2) in the standard library:
a signature exactly as long as the modulus and below it, ``pow(s, e,
n)``, and the whole encoded block ``00 01 FF.. 00 DigestInfo(SHA-256)
hash`` built and compared at once with ``hmac.compare_digest``. Nothing
in the block is parsed, so a padding that a loose parser would skip over
(Bleichenbacher's 2006 forgery against small exponents) cannot pass.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import threading
import time
import urllib.request
from typing import Optional

from gofr_tpu_torch.http.middleware.basic_auth import exempt
from gofr_tpu_torch.http.proto import Response

# DER of DigestInfo { sha256, NULL } before the 32-byte hash (RFC 8017
# §9.2, note 1).
_SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")


def _b64url_decode(segment: str) -> bytes:
    pad = "=" * (-len(segment) % 4)
    return base64.urlsafe_b64decode(segment + pad)


def _b64url_to_int(segment: str) -> int:
    return int.from_bytes(_b64url_decode(segment), "big")


def rsa_public_key(n: int, e: int) -> tuple[int, int]:
    """``(n, e)`` of a usable RSA public key; ``ValueError`` for numbers no
    RSA key has (an even or tiny modulus, an even exponent or one not
    below the modulus)."""
    if n < 3 or n % 2 == 0 or e < 3 or e % 2 == 0 or e >= n:
        raise ValueError("invalid RSA public numbers")
    return n, e


def rs256_verify(key: tuple[int, int], signature: bytes, message: bytes) -> bool:
    """RSASSA-PKCS1-v1_5 verification with SHA-256 (RFC 8017 §8.2.2):
    True only when ``signature`` is ``k`` bytes (the modulus's length),
    below ``n``, and ``s^e mod n`` is exactly the encoded block of
    ``message``'s hash."""
    n, e = key
    k = (n.bit_length() + 7) // 8
    t = _SHA256_DIGEST_INFO + hashlib.sha256(message).digest()
    if len(signature) != k or k < len(t) + 11:
        return False
    s = int.from_bytes(signature, "big")
    if s >= n:
        return False
    em = pow(s, e, n).to_bytes(k, "big")
    expected = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    return hmac.compare_digest(em, expected)


class JWKSProvider:
    """kid → RSA public key ``(n, e)`` cache with periodic refresh."""

    def __init__(self, jwks_url: str, refresh_interval_s: float = 300.0, logger=None) -> None:
        self._url = jwks_url
        self._interval = refresh_interval_s
        self._logger = logger
        self._keys: dict[str, tuple[int, int]] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self) -> None:
        if self._thread is not None:
            return
        self.refresh()
        self._thread = threading.Thread(target=self._run, name="jwks-refresh", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self.refresh()

    def refresh(self) -> None:
        try:
            with urllib.request.urlopen(self._url, timeout=5) as resp:
                jwks = json.loads(resp.read().decode())
            keys = {}
            for jwk in jwks.get("keys", []):
                if jwk.get("kty") != "RSA":
                    continue
                try:
                    keys[jwk.get("kid", "")] = rsa_public_key(
                        _b64url_to_int(jwk["n"]), _b64url_to_int(jwk["e"]))
                except Exception:  # noqa: BLE001 — a bad key is skipped, as the reference
                    continue
            with self._lock:
                self._keys = keys
        except Exception as exc:  # noqa: BLE001 — a dead endpoint keeps the old keys
            if self._logger is not None:
                self._logger.debugf("JWKS refresh failed: %s", exc)

    def key(self, kid: str) -> Optional[tuple[int, int]]:
        with self._lock:
            return self._keys.get(kid)


def _verify_jwt(token: str, *, jwks: Optional[JWKSProvider], hs_secret: Optional[bytes]):
    """The claims dict, or ``ValueError`` with the reference's message."""
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
        header = json.loads(_b64url_decode(header_b64))
        payload = json.loads(_b64url_decode(payload_b64))
        signature = _b64url_decode(sig_b64)
    except Exception as exc:
        raise ValueError("malformed token") from exc

    alg = header.get("alg")
    signing_input = f"{header_b64}.{payload_b64}".encode()
    if alg == "RS256":
        if jwks is None:
            raise ValueError("no JWKS provider configured")
        key = jwks.key(header.get("kid", ""))
        if key is None:
            raise ValueError("unknown key id")
        if not rs256_verify(key, signature, signing_input):
            raise ValueError("invalid signature")
    elif alg == "HS256":
        if hs_secret is None:
            raise ValueError("no shared secret configured")
        expected = hmac.new(hs_secret, signing_input, hashlib.sha256).digest()
        if not hmac.compare_digest(expected, signature):
            raise ValueError("invalid signature")
    else:
        raise ValueError(f"unsupported alg {alg}")

    exp = payload.get("exp")
    if exp is not None and time.time() > float(exp):
        raise ValueError("token expired")
    return payload


def oauth_middleware(jwks: Optional[JWKSProvider] = None, hs_secret: Optional[bytes] = None):
    def mw(next_handler):
        async def handler(raw):
            if exempt(raw):
                return await next_handler(raw)
            header = raw.headers.get("authorization", "")
            if not header.startswith("Bearer "):
                return _unauthorized("authorization header missing")
            try:
                claims = _verify_jwt(header[7:], jwks=jwks, hs_secret=hs_secret)
            except ValueError as exc:
                return _unauthorized(str(exc))
            # The reference's JWTClaim context key (oauth.go:22-24).
            raw.ctx_data["JWTClaims"] = claims
            return await next_handler(raw)

        return handler

    return mw


def _unauthorized(msg: str) -> Response:
    return Response(
        status=401,
        headers={"Content-Type": "application/json"},
        body=json.dumps({"error": {"message": msg}}).encode(),
    )
