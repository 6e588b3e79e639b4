"""Connect built-in CA: root generation, leaf signing, rotation; the
port's copy of ``consul_tpu/connect/ca.py``.

Equivalent of the reference's built-in CA provider
(``agent/connect/ca/provider_consul.go`` + ``agent/connect/``): an EC
P-256 root certificate per datacenter signs short-lived leaf
certificates whose URI SAN is the service's SPIFFE identity

    spiffe://<trust-domain>/ns/default/dc/<dc>/svc/<service>

(``agent/connect/uri_service.go``).  Rotation generates a new root and
marks it active; old roots stay in the store so already-issued leaves
keep verifying until they expire, and the OLD key cross-signs the new
root (``provider_consul.go CrossSignCA`` / ``leader_connect.go``
rotation): leaves signed by the new root carry the cross-signed
intermediate in their chain, so a peer still pinned to the old root
keeps verifying new leaves until its root set refreshes.
"""

from __future__ import annotations

import datetime
import types
import uuid
from typing import Optional

LEAF_TTL = datetime.timedelta(hours=72)   # ca config LeafCertTTL default
ROOT_TTL = datetime.timedelta(days=10 * 365)


def _crypto() -> types.SimpleNamespace:
    """The optional ``cryptography`` toolkit, imported on first use so
    agents that never touch Connect TLS run in minimal containers."""
    try:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID
    except ImportError as e:
        raise RuntimeError(
            "Connect CA operations require the optional 'cryptography' "
            "package (pip install cryptography)"
        ) from e
    return types.SimpleNamespace(
        x509=x509, hashes=hashes, serialization=serialization, ec=ec,
        NameOID=NameOID,
    )


def spiffe_service(trust_domain: str, dc: str, service: str) -> str:
    return f"spiffe://{trust_domain}/ns/default/dc/{dc}/svc/{service}"


def spiffe_agent(trust_domain: str, dc: str, node: str) -> str:
    """agent/connect/uri_agent.go SpiffeIDAgent."""
    return f"spiffe://{trust_domain}/agent/client/dc/{dc}/id/{node}"


def _now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


class BuiltinCA:
    """One datacenter's signing authority."""

    def __init__(self, dc: str, trust_domain: Optional[str] = None):
        self.dc = dc
        self.trust_domain = trust_domain or f"{uuid.uuid4()}.consul"
        self._key: Optional[ec.EllipticCurvePrivateKey] = None
        self._cert: Optional[x509.Certificate] = None
        # Cross-signed form of the CURRENT root, issued by the previous
        # root's key at rotation time (provider_consul.go CrossSignCA);
        # rides along in leaf chains for old-root-pinned verifiers.
        self._cross_pem: Optional[str] = None
        self.root_id = ""

    # ------------------------------------------------------------------
    # roots
    # ------------------------------------------------------------------

    def generate_root(self) -> dict:
        """A fresh self-signed root (provider_consul.go GenerateRoot);
        returns the store record for connect_ca_roots."""
        c = _crypto()
        self._key = c.ec.generate_private_key(c.ec.SECP256R1())
        self.root_id = str(uuid.uuid4())
        name = c.x509.Name([
            c.x509.NameAttribute(
                c.NameOID.COMMON_NAME, f"Consul CA {self.root_id[:8]}"
            ),
        ])
        now = _now()
        self._cert = (
            c.x509.CertificateBuilder()
            .subject_name(name)
            .issuer_name(name)
            .public_key(self._key.public_key())
            .serial_number(c.x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=1))
            .not_valid_after(now + ROOT_TTL)
            .add_extension(
                # path_length=1: the root must be allowed ONE subordinate
                # CA below it — the cross-signed intermediate minted at
                # rotation (RFC 5280 pathLenConstraint; pathlen=0 would
                # make every leaf->cross->old-root chain invalid to
                # standards-compliant verifiers like OpenSSL).
                c.x509.BasicConstraints(ca=True, path_length=1),
                critical=True,
            )
            .add_extension(
                c.x509.SubjectAlternativeName([
                    c.x509.UniformResourceIdentifier(
                        f"spiffe://{self.trust_domain}"
                    )
                ]),
                critical=False,
            )
            .sign(self._key, c.hashes.SHA256())
        )
        return {
            "id": self.root_id,
            "name": f"Consul CA Root Cert",
            "root_cert": self.root_pem(),
            "trust_domain": self.trust_domain,
            "active": True,
        }

    def root_pem(self) -> str:
        assert self._cert is not None
        return self._cert.public_bytes(
            _crypto().serialization.Encoding.PEM
        ).decode()

    def rotate(self) -> dict:
        """New active root; the caller stores it (old roots retained).
        The outgoing key CROSS-SIGNS the incoming root
        (provider_consul.go CrossSignCA): the returned record carries
        the cross-signed intermediate, and every leaf signed from now
        until the next rotation includes it in its chain."""
        old_key, old_cert = self._key, self._cert
        rec = self.generate_root()
        self._cross_pem = None
        if old_key is not None and old_cert is not None:
            c = _crypto()
            now = _now()
            cross = (
                c.x509.CertificateBuilder()
                .subject_name(self._cert.subject)      # NEW root's name
                .issuer_name(old_cert.subject)         # signed by OLD
                .public_key(self._key.public_key())    # NEW root's key
                .serial_number(c.x509.random_serial_number())
                .not_valid_before(now - datetime.timedelta(minutes=1))
                .not_valid_after(now + ROOT_TTL)
                .add_extension(
                    c.x509.BasicConstraints(ca=True, path_length=0),
                    critical=True,
                )
                .sign(old_key, c.hashes.SHA256())
            )
            self._cross_pem = cross.public_bytes(
                c.serialization.Encoding.PEM).decode()
            rec["cross_signed_cert"] = self._cross_pem
        return rec

    # ------------------------------------------------------------------
    # leaves
    # ------------------------------------------------------------------

    def sign_leaf(self, service: str, kind: str = "service") -> dict:
        """Issue a leaf (provider_consul.go Sign): EC key + cert with
        the SPIFFE URI SAN, signed by the active root.  ``kind`` picks
        the identity shape: a service, or an AGENT (auto-encrypt's
        client TLS bootstrap, auto_encrypt_endpoint.go Sign)."""
        assert self._cert is not None and self._key is not None
        c = _crypto()
        key = c.ec.generate_private_key(c.ec.SECP256R1())
        if kind == "agent":
            uri = spiffe_agent(self.trust_domain, self.dc, service)
        else:
            uri = spiffe_service(self.trust_domain, self.dc, service)
        now = _now()
        cert = (
            c.x509.CertificateBuilder()
            .subject_name(c.x509.Name([
                c.x509.NameAttribute(c.NameOID.COMMON_NAME, service),
            ]))
            .issuer_name(self._cert.subject)
            .public_key(key.public_key())
            .serial_number(c.x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=1))
            .not_valid_after(now + LEAF_TTL)
            .add_extension(
                c.x509.SubjectAlternativeName(
                    [c.x509.UniformResourceIdentifier(uri)]
                ),
                critical=False,
            )
            .add_extension(
                c.x509.BasicConstraints(ca=False, path_length=None),
                critical=True,
            )
            .sign(self._key, c.hashes.SHA256())
        )
        return {
            "service": service,
            "uri": uri,
            "cert_pem": cert.public_bytes(
                c.serialization.Encoding.PEM
            ).decode(),
            "key_pem": key.private_bytes(
                c.serialization.Encoding.PEM,
                c.serialization.PrivateFormat.PKCS8,
                c.serialization.NoEncryption(),
            ).decode(),
            "root_id": self.root_id,
            # Chain material for old-root-pinned verifiers (empty when
            # no rotation has happened under this provider).
            "intermediate_pems": (
                [self._cross_pem] if self._cross_pem else []
            ),
            "valid_after": cert.not_valid_before_utc.isoformat(),
            "valid_before": cert.not_valid_after_utc.isoformat(),
        }


def verify_leaf_chain(
    leaf_pem: str, intermediate_pems: list[str], root_pem: str
) -> Optional[str]:
    """Verify a leaf through its cross-signed intermediates against a
    trusted root (connect/tls.go chain verification): the path is
    leaf → intermediate (new root cross-signed by old) → root."""
    direct = verify_leaf(leaf_pem, root_pem)
    if direct is not None:
        return direct
    c = _crypto()
    for inter_pem in intermediate_pems or []:
        try:
            inter = c.x509.load_pem_x509_certificate(inter_pem.encode())
            root = c.x509.load_pem_x509_certificate(root_pem.encode())
            inter.verify_directly_issued_by(root)
        except Exception:  # noqa: BLE001 - try the next intermediate
            continue
        via = verify_leaf(leaf_pem, inter_pem)
        if via is not None:
            return via
    return None


def verify_leaf(leaf_pem: str, root_pem: str) -> Optional[str]:
    """Verify a leaf against a root; returns its SPIFFE URI when valid,
    None otherwise (connect/tls.go verification core)."""
    c = _crypto()
    try:
        leaf = c.x509.load_pem_x509_certificate(leaf_pem.encode())
        root = c.x509.load_pem_x509_certificate(root_pem.encode())
        leaf.verify_directly_issued_by(root)
    except Exception:  # noqa: BLE001 - any failure = invalid
        return None
    now = _now()
    if not (leaf.not_valid_before_utc <= now <= leaf.not_valid_after_utc):
        return None
    try:
        san = leaf.extensions.get_extension_for_class(
            c.x509.SubjectAlternativeName
        )
        uris = san.value.get_values_for_type(
            c.x509.UniformResourceIdentifier
        )
        return uris[0] if uris else None
    except c.x509.ExtensionNotFound:
        return None
