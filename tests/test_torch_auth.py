"""The port's auth enablers (``App.enable_basic_auth``, ``enable_api_key_auth``,
their ``_with_validator`` forms, ``enable_oauth`` and ``oauth_middleware``)
against the reference's App on the CPU: the same routes on port 0, the
same requests over real sockets, the same status, body and headers
(``Content-Type``, ``WWW-Authenticate``).

The cases are the reference's own (``tests/test_oauth_jwks.py`` and
``tests/test_parity_misc.py``'s auth tests, its HS256 case included). RS256
tokens are signed here with ``cryptography`` (the RSA cases skip without
it, as the reference's do) and the port checks them in the standard
library; beside the reference's rejections, five forgeries that
``cryptography`` refuses must get the port's 401 too: one signature byte
flipped, a signature one byte short, a signature not below the modulus,
a DigestInfo for SHA-1, and garbage after the hash in the padding.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

import gofr_tpu
import gofr_tpu.config
import gofr_tpu_torch
import gofr_tpu_torch.config
from gofr_tpu.http.middleware import oauth_middleware as ref_oauth_middleware
from gofr_tpu_torch.http.middleware import JWKSProvider, oauth_middleware
from gofr_tpu_torch.http.middleware.oauth import rs256_verify
from tests.test_torch_framework import Harness

PKGS = {"port": gofr_tpu_torch, "reference": gofr_tpu}
HEADERS = ("Content-Type", "WWW-Authenticate")


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _int_b64url(n: int) -> str:
    return _b64url(n.to_bytes((n.bit_length() + 7) // 8, "big"))


def _app(pkg: str, enable):
    mod = PKGS[pkg]
    app = mod.App(config=mod.config.MockConfig({"HTTP_PORT": "0", "METRICS_PORT": "0"}))
    app.get("/secret", lambda ctx: "classified")

    @app.get("/claims")
    def claims(ctx):
        return ctx.get("JWTClaims")

    enable(app, pkg)
    return app


def _both(enable, requests: list) -> list:
    """Each request to both Apps: [(status, headers kept, body)] per
    request, equal between the packages."""
    out = {}
    for pkg in PKGS:
        with Harness(_app(pkg, enable)) as h:
            got = []
            for path, headers in requests:
                status, hdrs, body = h.request("GET", path, headers=headers)
                got.append((status, {k: hdrs.get(k) for k in HEADERS}, body))
            out[pkg] = got
    assert out["port"] == out["reference"]
    return out["port"]


def test_basic_auth_enabled_app():
    """test_parity_misc.py::test_basic_auth_enabled_app on both: 401 without
    or with wrong credentials (``WWW-Authenticate: Basic``), a broken
    header's own message, 200 with them, the probes open."""
    good = base64.b64encode(b"admin:pw123").decode()
    bad = base64.b64encode(b"admin:nope").decode()
    got = _both(lambda app, pkg: app.enable_basic_auth({"admin": "pw123"}), [
        ("/secret", {}), ("/secret", {"Authorization": f"Basic {good}"}),
        ("/secret", {"Authorization": f"Basic {bad}"}),
        ("/secret", {"Authorization": "Basic a"}),
        ("/secret", {"Authorization": "Bearer x"}), ("/.well-known/alive", {})])
    assert [g[0] for g in got] == [401, 200, 401, 401, 401, 200]
    assert json.loads(got[1][2])["data"] == "classified"
    assert got[0][1]["WWW-Authenticate"] == "Basic"
    assert json.loads(got[3][2]) == {"error": {"message": "invalid authorization header"}}


def test_basic_auth_with_validator_receives_the_container():
    seen = {}

    def enable(app, pkg):
        def validate(container, user, password):
            seen[pkg] = container is app.container
            return (user, password) == ("ada", "lovelace")

        app.enable_basic_auth_with_validator(validate)

    good = base64.b64encode(b"ada:lovelace").decode()
    got = _both(enable, [("/secret", {"Authorization": f"Basic {good}"}),
                         ("/secret", {"Authorization": "Basic " + base64.b64encode(
                             b"ada:x").decode()})])
    assert [g[0] for g in got] == [200, 401]
    assert seen == {"port": True, "reference": True}


def test_api_key_auth_enabled_app():
    """test_parity_misc.py::test_api_key_auth_enabled_app on both, and the
    validator form, which receives the container."""
    got = _both(lambda app, pkg: app.enable_api_key_auth("key-1", "key-2"), [
        ("/secret", {}), ("/secret", {"X-API-KEY": "key-2"}), ("/secret", {"X-API-KEY": "key"}),
        ("/.well-known/health", {})])
    assert [g[0] for g in got] == [401, 200, 401, 200]
    assert json.loads(got[0][2]) == {"error": {"message": "Unauthorized"}}
    got = _both(lambda app, pkg: app.enable_api_key_auth_with_validator(
        lambda container, key: container is app.container and key == "k"), [
        ("/secret", {"X-API-KEY": "k"}), ("/secret", {"X-API-KEY": "j"})])
    assert [g[0] for g in got] == [200, 401]


def _hs256(secret: bytes, payload: dict) -> str:
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    body = _b64url(json.dumps(payload).encode())
    sig = hmac.new(secret, f"{header}.{body}".encode(), hashlib.sha256).digest()
    return f"{header}.{body}.{_b64url(sig)}"


def test_oauth_hs256_jwt_middleware():
    """test_parity_misc.py::test_oauth_hs256_jwt_middleware on both: the
    claims reach the handler; missing, expired, tampered and RS256 tokens
    (no JWKS provider) get the reference's 401 bodies."""
    secret = b"shh"
    good = _hs256(secret, {"sub": "ada", "exp": time.time() + 60})
    expired = _hs256(secret, {"sub": "ada", "exp": time.time() - 10})
    rs = f"{_b64url(json.dumps({'alg': 'RS256'}).encode())}.{good.split('.', 1)[1]}"

    def enable(app, pkg):
        mw = oauth_middleware if pkg == "port" else ref_oauth_middleware
        app.use_middleware(mw(hs_secret=secret))

    got = _both(enable, [(path, {"Authorization": f"Bearer {tok}"} if tok else {})
                         for path, tok in (("/claims", None), ("/claims", good),
                                           ("/claims", expired), ("/claims", good[:-4] + "AAAA"),
                                           ("/claims", rs), ("/.well-known/alive", None))])
    assert [g[0] for g in got] == [401, 200, 401, 401, 401, 200]
    assert json.loads(got[1][2])["data"]["sub"] == "ada"
    assert [json.loads(g[2])["error"]["message"] for g in got if g[0] == 401] == [
        "authorization header missing", "token expired", "invalid signature",
        "no JWKS provider configured"]


# -- RS256 through enable_oauth and a JWKS endpoint --------------------------


@pytest.fixture(scope="module")
def rsa_key():
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives.asymmetric import rsa

    return rsa.generate_private_key(public_exponent=65537, key_size=2048)


@pytest.fixture(scope="module")
def jwks_url(rsa_key):
    pub = rsa_key.public_key().public_numbers()
    jwks = {"keys": [
        {"kty": "oct", "kid": "sym"},  # not RSA: skipped
        {"kty": "RSA", "kid": "bad", "n": "!!!", "e": "AQAB"},  # unusable: skipped
        {"kty": "RSA", "kid": "test-key", "n": _int_b64url(pub.n), "e": _int_b64url(pub.e)},
    ]}

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps(jwks).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_port}/jwks.json"
    srv.shutdown()


def _jwt(rsa_key, kid="test-key", alg="RS256", exp=None, claims=None) -> str:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    payload = {"sub": "user-1", **(claims or {})}
    if exp is not None:
        payload["exp"] = exp
    h = _b64url(json.dumps({"alg": alg, "kid": kid}).encode())
    p = _b64url(json.dumps(payload).encode())
    sig = rsa_key.sign(f"{h}.{p}".encode(), padding.PKCS1v15(), hashes.SHA256())
    return f"{h}.{p}.{_b64url(sig)}"


def _forged(rsa_key, block: bytes) -> int:
    """The RSA signature whose public operation gives ``block`` (the
    private exponent applied to it)."""
    priv = rsa_key.private_numbers()
    return pow(int.from_bytes(block, "big"), priv.d, priv.public_numbers.n)


def _forgeries(rsa_key) -> dict:
    """Tokens whose signatures cryptography refuses, each a known attack
    on a loose PKCS#1 v1.5 check."""
    n = rsa_key.public_key().public_numbers().n
    k = (n.bit_length() + 7) // 8
    token = _jwt(rsa_key)
    h, p, s = token.split(".")
    sig = _b64url_decode(s)
    signed = f"{h}.{p}".encode()
    sha1_info = bytes.fromhex("3021300906052b0e03021a05000414") + hashlib.sha1(signed).digest()
    sha256_info = (bytes.fromhex("3031300d060960864801650304020105000420")
                   + hashlib.sha256(signed).digest())
    garbage = b"\x00\x01" + b"\xff" * 8 + b"\x00" + sha256_info
    garbage += b"\x5a" * (k - len(garbage))

    def with_sig(raw: bytes) -> str:
        return f"{h}.{p}.{_b64url(raw)}"

    flipped = bytearray(sig)
    flipped[len(sig) // 2] ^= 0x01
    return {
        "byte flipped": with_sig(bytes(flipped)),
        "one byte short": with_sig(sig[1:] if sig[0] == 0 else sig[:-1]),
        "not below n": with_sig((int.from_bytes(sig, "big") + n).to_bytes(k + 1, "big")[-k:]
                                if int.from_bytes(sig, "big") + n < 256**k
                                else n.to_bytes(k, "big")),
        "sha1 digest info": with_sig(_forged(rsa_key, b"\x00\x01" + b"\xff" * (
            k - len(sha1_info) - 3) + b"\x00" + sha1_info).to_bytes(k, "big")),
        "garbage after the hash": with_sig(_forged(rsa_key, garbage).to_bytes(k, "big")),
    }


def _b64url_decode(segment: str) -> bytes:
    return base64.urlsafe_b64decode(segment + "=" * (-len(segment) % 4))


def test_rs256_through_enable_oauth(rsa_key, jwks_url):
    """tests/test_oauth_jwks.py on both Apps (``enable_oauth`` against a
    JWKS endpoint served here): a valid token's claims; missing and
    malformed tokens, an unknown kid, a tampered payload, an expired token
    and an unsupported alg each a 401 with the reference's body; the
    probes open; and the five forgeries a 401 ("invalid signature") on
    both."""
    token = _jwt(rsa_key)
    h, p, s = token.split(".")
    forged = json.loads(_b64url_decode(p))
    forged["sub"] = "attacker"
    tampered = f"{h}.{_b64url(json.dumps(forged).encode())}.{s}"
    forgeries = _forgeries(rsa_key)
    cases = [None, "not.a.jwt", token, _jwt(rsa_key, kid="nope"), tampered,
             _jwt(rsa_key, exp=time.time() - 60), _jwt(rsa_key, exp=time.time() + 3600),
             _jwt(rsa_key, alg="none"), *forgeries.values()]
    requests = [("/claims", {"Authorization": f"Bearer {t}"} if t else {}) for t in cases]
    got = _both(lambda app, pkg: app.enable_oauth(jwks_url, refresh_interval_s=3600.0),
                requests + [("/.well-known/alive", {})])
    statuses = [g[0] for g in got]
    assert statuses == [401, 401, 200, 401, 401, 401, 200, 401] + [401] * len(forgeries) + [200]
    assert json.loads(got[2][2])["data"]["sub"] == "user-1"
    messages = [json.loads(g[2])["error"]["message"] for g in got if g[0] == 401]
    assert messages == ["authorization header missing", "malformed token", "unknown key id",
                        "invalid signature", "token expired", "unsupported alg none"] + [
        "invalid signature"] * len(forgeries)


def test_rs256_verify_against_cryptography(rsa_key):
    """The standard-library check agrees with cryptography's on a real
    signature and on each forgery, and refuses a key too small to hold
    the SHA-256 block."""
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    pub = rsa_key.public_key()
    key = (pub.public_numbers().n, pub.public_numbers().e)
    for name, token in {"valid": _jwt(rsa_key), **_forgeries(rsa_key)}.items():
        h, p, s = token.split(".")
        sig, msg = _b64url_decode(s), f"{h}.{p}".encode()
        try:
            pub.verify(sig, msg, padding.PKCS1v15(), hashes.SHA256())
            theirs = True
        except (InvalidSignature, ValueError):
            theirs = False
        assert rs256_verify(key, sig, msg) is theirs is (name == "valid"), name
    assert not rs256_verify((2**255 + 1, 65537), b"\x01" * 32, b"m")


def test_provider_survives_a_dead_endpoint():
    """test_oauth_jwks.py::test_provider_survives_dead_endpoint: refresh
    does not raise, no key, the failure logged at debug."""
    logged = []

    class Logger:
        def debugf(self, fmt, *args):
            logged.append(fmt % args)

    provider = JWKSProvider("http://127.0.0.1:1/nope", refresh_interval_s=3600.0,
                            logger=Logger())
    provider.refresh()
    assert provider.key("anything") is None
    assert logged and logged[0].startswith("JWKS refresh failed")
    provider.stop()
