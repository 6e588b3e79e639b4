"""Connect service mesh core: built-in CA + SPIFFE identities +
intention-based authorization (agent/connect + agent/consul connect
endpoints); the port's copy of ``consul_tpu/connect/__init__.py``, which
also exports the mesh-gateway locator (``connect/gateways.py``) that
every ``Server`` builds.  ``cryptography`` is imported only when a
certificate is made or read (``connect/ca.py``)."""

from consul_tpu_torch.connect.ca import (
    BuiltinCA,
    spiffe_agent,
    spiffe_service,
    verify_leaf,
)
from consul_tpu_torch.connect.gateways import GatewayLocator
from consul_tpu_torch.connect.service import ConnectError, Service

__all__ = [
    "BuiltinCA",
    "ConnectError",
    "GatewayLocator",
    "Service",
    "spiffe_agent",
    "spiffe_service",
    "verify_leaf",
]
