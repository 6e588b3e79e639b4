"""Gossip encryption: AES-GCM payload sealing with a rotating keyring; the
port's copy of ``consul_tpu/net/security.py``.

Equivalent of ``memberlist/security.go`` + ``memberlist/keyring.go``:
every gossip packet and stream frame is sealed with the PRIMARY key;
inbound payloads are opened by trying every installed key, so the
cluster stays intact mid-rotation (install everywhere → use everywhere
→ remove old, ``serf/keymanager.go``).

Wire format (security.go encryptPayload, version 1):

    [ENCRYPT byte][version=1][12-byte nonce][AES-GCM ciphertext+tag]

The message-type byte is the same slot the reference uses
(net.go:44-59 encryptMsg); the version byte is authenticated as AAD.
Keys are 16/24/32 bytes (AES-128/192/256), base64 in config — the
reference's ``encrypt`` setting / ``consul keygen``.
"""

from __future__ import annotations

import base64
import os
from typing import Optional

ENCRYPTION_VERSION = 1
NONCE_SIZE = 12
KEY_SIZES = (16, 24, 32)


class SecurityError(Exception):
    """Undecryptable or malformed sealed payload."""


class CryptoUnavailable(SecurityError, RuntimeError):
    """No AEAD to seal or open with: the optional ``cryptography`` package
    is missing.  A ``RuntimeError`` as the reference raises it, and a
    ``SecurityError``, so a caller that drops what it cannot open drops
    this too; nothing is ever sent or accepted in plaintext."""


def _aesgcm(key: bytes):
    """The optional ``cryptography`` AEAD, imported on first seal/open —
    keyring bookkeeping and keygen stay usable without the package."""
    try:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    except ImportError as e:
        raise CryptoUnavailable(
            "gossip encryption requires the optional 'cryptography' "
            "package (pip install cryptography), or run with "
            "encryption disabled"
        ) from e
    return AESGCM(key)


def generate_key(size: int = 32) -> str:
    """``consul keygen``: a fresh random key, base64."""
    return base64.b64encode(os.urandom(size)).decode()


def decode_key(b64: str) -> bytes:
    key = base64.b64decode(b64)
    if len(key) not in KEY_SIZES:
        raise ValueError(
            f"gossip key must be {KEY_SIZES} bytes, got {len(key)}"
        )
    return key


class Keyring:
    """memberlist/keyring.go Keyring: primary + installed keys."""

    def __init__(self, keys: list[bytes], primary: bytes):
        if primary not in keys:
            keys = [primary] + list(keys)
        for k in keys:
            if len(k) not in KEY_SIZES:
                raise ValueError(f"bad key size {len(k)}")
        self._keys = list(keys)
        self._primary = primary

    @classmethod
    def from_b64(cls, primary_b64: str) -> "Keyring":
        key = decode_key(primary_b64)
        return cls([key], key)

    # -- rotation (keyring.go AddKey/UseKey/RemoveKey) -----------------

    def install(self, b64: str) -> None:
        key = decode_key(b64)
        if key not in self._keys:
            self._keys.append(key)

    def use(self, b64: str) -> None:
        key = decode_key(b64)
        if key not in self._keys:
            raise ValueError("requested key is not in the keyring")
        self._primary = key

    def remove(self, b64: str) -> None:
        key = decode_key(b64)
        if key == self._primary:
            raise ValueError("removing the primary key is not allowed")
        if key in self._keys:
            self._keys.remove(key)

    def list_keys(self) -> list[str]:
        return [base64.b64encode(k).decode() for k in self._keys]

    def primary_b64(self) -> str:
        return base64.b64encode(self._primary).decode()

    # -- sealing (security.go encryptPayload/decryptPayload) -----------

    def encrypt(self, payload: bytes) -> bytes:
        nonce = os.urandom(NONCE_SIZE)
        version = bytes([ENCRYPTION_VERSION])
        ct = _aesgcm(self._primary).encrypt(nonce, payload, version)
        return version + nonce + ct

    def decrypt(self, blob: bytes) -> bytes:
        if len(blob) < 1 + NONCE_SIZE + 16:
            raise SecurityError("sealed payload too short")
        version, nonce, ct = blob[:1], blob[1:1 + NONCE_SIZE], blob[1 + NONCE_SIZE:]
        if version[0] != ENCRYPTION_VERSION:
            raise SecurityError(f"unknown encryption version {version[0]}")
        # Try every key: mid-rotation peers may still seal with an older
        # primary (security.go decryptPayload loops the keyring).
        for key in self._keys:
            aead = _aesgcm(key)  # missing-lib RuntimeError must escape
            try:
                return aead.decrypt(nonce, ct, version)
            except Exception:  # noqa: BLE001 - wrong key, try next
                continue
        raise SecurityError("no installed key decrypts the payload")
