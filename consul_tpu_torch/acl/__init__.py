"""ACL engine: policy parsing, radix enforcement, token resolution; the
port's copy of ``consul_tpu.acl``.

Equivalent of the reference's ``acl/`` package plus the server-side
resolver in ``agent/consul/acl.go`` (SURVEY.md §2.2).  ``jwt`` holds the
``jwt`` auth method's validation; it loads ``cryptography`` only for an
RS256/ES256 signature.
"""

from consul_tpu_torch.acl.engine import (
    ACLResolver,
    Authorizer,
    DENY_ALL,
    MANAGE_ALL,
    PREFIX_RESOURCES,
    READ,
    SCALAR_RESOURCES,
    WRITE,
    Policy,
    node_identity_policy,
    parse_policy,
    service_identity_policy,
    token_is_expired,
)

__all__ = [
    "ACLResolver",
    "Authorizer",
    "DENY_ALL",
    "MANAGE_ALL",
    "PREFIX_RESOURCES",
    "Policy",
    "READ",
    "SCALAR_RESOURCES",
    "WRITE",
    "node_identity_policy",
    "parse_policy",
    "service_identity_policy",
    "token_is_expired",
]
