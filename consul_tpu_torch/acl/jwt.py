"""Minimal JWT validation for the ``jwt`` auth method; the port's copy of
``consul_tpu/acl/jwt.py``.

Parity model: the reference validates bearer JWTs in its sso auth method
(``agent/consul/authmethod/ssoauth/sso.go`` via hashicorp/cap) with
locally-configured validation keys, bound issuer/audiences, and claim
mappings that project verified claims into binding-rule variables
(``agent/consul/authmethod/authmethods.go:56-66`` Identity).

Only what login needs is implemented: compact-serialization parsing,
HS256 (stdlib hmac) and RS256/ES256 (``cryptography``) signature checks,
exp/nbf with clock skew, and iss/aud binding.  No JWKS fetching — zero
egress; keys are configured on the auth method, matching the reference's
``JWTValidationPubKeys`` static-key mode.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Any, Optional


class JWTError(ValueError):
    """Malformed, unverifiable, or out-of-policy token."""


def _b64url_decode(part: str) -> bytes:
    pad = -len(part) % 4
    try:
        return base64.urlsafe_b64decode(part + "=" * pad)
    except Exception as e:  # binascii.Error subclasses ValueError
        raise JWTError(f"bad base64url segment: {e}") from e


def _b64url_encode(raw: bytes) -> str:
    return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()


def encode_hs256(claims: dict, secret: str) -> str:
    """Mint an HS256 JWT (test helper + ``consul login`` demos)."""
    header = _b64url_encode(json.dumps(
        {"alg": "HS256", "typ": "JWT"}, separators=(",", ":")).encode())
    body = _b64url_encode(json.dumps(
        claims, separators=(",", ":")).encode())
    signing_input = f"{header}.{body}".encode()
    sig = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    return f"{header}.{body}.{_b64url_encode(sig)}"


def _verify_signature(alg: str, signing_input: bytes, sig: bytes,
                      secret: str, pub_keys: list[str]) -> None:
    if alg == "HS256":
        if not secret:
            raise JWTError("auth method has no jwt_secret for HS256")
        want = hmac.new(secret.encode(), signing_input,
                        hashlib.sha256).digest()
        if not hmac.compare_digest(want, sig):
            raise JWTError("signature mismatch")
        return
    if alg in ("RS256", "ES256"):
        if not pub_keys:
            raise JWTError(
                "auth method has no jwt_validation_pub_keys for " + alg)
        try:
            from cryptography.exceptions import (
                InvalidSignature,
                UnsupportedAlgorithm,
            )
            from cryptography.hazmat.primitives import hashes, serialization
            from cryptography.hazmat.primitives.asymmetric import ec, padding
            from cryptography.hazmat.primitives.asymmetric.utils import (
                encode_dss_signature,
            )
        except ImportError as e:
            raise RuntimeError(
                f"{alg} JWT validation requires the optional "
                "'cryptography' package (pip install cryptography); "
                "HS256 works without it"
            ) from e
        for pem in pub_keys:
            # A malformed PEM or a key of the wrong type (EC key for
            # RS256, RSA for ES256) must not abort the loop — other
            # configured keys may still validate the token.
            try:
                key = serialization.load_pem_public_key(pem.encode())
                if alg == "RS256":
                    key.verify(sig, signing_input, padding.PKCS1v15(),
                               hashes.SHA256())
                else:
                    # JOSE ES256 signatures are raw r||s, 32 bytes each.
                    if len(sig) != 64:
                        raise InvalidSignature()
                    der = encode_dss_signature(
                        int.from_bytes(sig[:32], "big"),
                        int.from_bytes(sig[32:], "big"),
                    )
                    key.verify(der, signing_input, ec.ECDSA(hashes.SHA256()))
                return
            except (InvalidSignature, ValueError, TypeError,
                    AttributeError, UnsupportedAlgorithm):
                continue
        raise JWTError("signature matches no configured validation key")
    raise JWTError(f"unsupported JWT alg {alg!r}")


def validate(
    token: str,
    *,
    secret: str = "",
    pub_keys: Optional[list[str]] = None,
    bound_issuer: str = "",
    bound_audiences: Optional[list[str]] = None,
    clock_skew_s: float = 30.0,
    now: Optional[float] = None,
) -> dict[str, Any]:
    """Verify signature + time window + issuer/audience; return claims."""
    parts = token.split(".")
    if len(parts) != 3:
        raise JWTError("not a compact-serialization JWT")
    try:
        header = json.loads(_b64url_decode(parts[0]))
        claims = json.loads(_b64url_decode(parts[1]))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise JWTError(f"bad JWT segment: {e}") from e
    if not isinstance(header, dict) or not isinstance(claims, dict):
        raise JWTError("JWT header/claims must be JSON objects")
    _verify_signature(
        str(header.get("alg", "")),
        f"{parts[0]}.{parts[1]}".encode(),
        _b64url_decode(parts[2]),
        secret,
        pub_keys or [],
    )
    t = time.time() if now is None else now
    try:
        exp = claims.get("exp")
        if exp is not None and t > float(exp) + clock_skew_s:
            raise JWTError("token is expired")
        nbf = claims.get("nbf")
        if nbf is not None and t < float(nbf) - clock_skew_s:
            raise JWTError("token not yet valid")
    except (TypeError, ValueError) as e:
        # Non-numeric exp/nbf in an otherwise valid token must still
        # surface as a JWT failure (the canonical 403), not leak out as
        # a bare conversion error.
        if isinstance(e, JWTError):
            raise
        raise JWTError(f"bad exp/nbf claim: {e}") from e
    if bound_issuer and claims.get("iss") != bound_issuer:
        raise JWTError("issuer mismatch")
    if bound_audiences:
        aud = claims.get("aud")
        auds = aud if isinstance(aud, list) else [aud]
        if not any(a in bound_audiences for a in auds):
            raise JWTError("audience not bound")
    return claims


def _claim_at(claims: dict, path: str) -> Any:
    """Resolve ``/nested/claim`` or plain ``claim`` paths (the
    reference's claim mappings accept JSON-pointer-ish selectors)."""
    node: Any = claims
    for seg in path.lstrip("/").split("/"):
        if not isinstance(node, dict) or seg not in node:
            return None
        node = node[seg]
    return node


def identity_from_claims(
    claims: dict,
    claim_mappings: Optional[dict[str, str]] = None,
    list_claim_mappings: Optional[dict[str, str]] = None,
) -> tuple[dict, dict[str, str]]:
    """Project claims into (selectable_fields, projected_vars).

    Selectable fields follow the reference's ssoauth shape: scalar
    mappings land under ``value.<name>`` and list mappings under
    ``list.<name>``, which is what binding-rule selectors address.
    """
    values: dict[str, str] = {}
    lists: dict[str, list[str]] = {}
    for path, name in (claim_mappings or {}).items():
        v = _claim_at(claims, path)
        if v is not None and not isinstance(v, (dict, list)):
            values[name] = str(v)
    for path, name in (list_claim_mappings or {}).items():
        v = _claim_at(claims, path)
        if isinstance(v, list):
            lists[name] = [str(x) for x in v]
        elif v is not None and not isinstance(v, dict):
            lists[name] = [str(v)]
    selectable = {"value": values, "list": lists}
    return selectable, dict(values)
