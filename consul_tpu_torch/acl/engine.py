"""Policy model + enforcement + token resolution; the port's copy of
``consul_tpu/acl/engine.py``.

Mirrors the reference's ACL system (``acl/policy.go``, ``acl/acl.go``,
``agent/consul/acl.go``):

  policy rules    resource rule lists — key/key_prefix, service, node,
                  session, event, query, agent + scalar operator/keyring
                  perms, each deny|read|write (policy.go PolicyRules)
  enforcement     longest-prefix match per resource (the reference
                  compiles rules into a radix tree, acl.go
                  enforce); exact rules beat prefix rules; on equal
                  specificity across merged policies DENY wins
                  (policy merge semantics of MergePolicies)
  tokens          token secret → policy set via the state store's
                  acl_tokens/acl_policies tables; unknown token →
                  "ACL not found"; anonymous token → default policy
                  (consul/acl.go ResolveToken)
  caching         resolved authorizers cached with a TTL
                  (config ACLTokenTTL, default 30s)
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Optional

DENY = "deny"
READ = "read"
WRITE = "write"

_LEVEL = {DENY: 0, READ: 1, WRITE: 2}

# Resource kinds with prefix rules (policy.go PolicyRules fields).
PREFIX_RESOURCES = (
    "key", "service", "node", "session", "event", "query", "agent",
)
# Scalar (cluster-wide) permissions.
SCALAR_RESOURCES = ("operator", "keyring", "acl")


class ACLError(Exception):
    """Permission denied / token not found (acl.ErrPermissionDenied)."""


@dataclasses.dataclass
class Rule:
    prefix: str
    policy: str  # deny|read|write
    exact: bool = False  # "key" exact rule vs "key_prefix" rule


@dataclasses.dataclass
class Policy:
    """One parsed policy document."""

    rules: dict[str, list[Rule]] = dataclasses.field(
        default_factory=lambda: {r: [] for r in PREFIX_RESOURCES}
    )
    scalars: dict[str, str] = dataclasses.field(default_factory=dict)


def parse_policy(src) -> Policy:
    """Parse a policy document (acl/policy.go Parse).

    Accepts a dict or JSON string in the reference's JSON policy shape:

        {"key_prefix": {"foo/": {"policy": "read"}},
         "key": {"foo/bar": {"policy": "write"}},
         "service_prefix": {"": {"policy": "read"}},
         "operator": "read"}
    """
    if isinstance(src, str):
        src = json.loads(src) if src.strip() else {}
    policy = Policy()
    for raw_kind, body in src.items():
        kind = raw_kind.removesuffix("_prefix")
        exact = not raw_kind.endswith("_prefix")
        if kind in SCALAR_RESOURCES:
            if body not in _LEVEL:
                raise ValueError(f"invalid policy {body!r} for {kind}")
            policy.scalars[kind] = body
            continue
        if kind not in PREFIX_RESOURCES:
            raise ValueError(f"unknown ACL resource {raw_kind!r}")
        if not isinstance(body, dict):
            raise ValueError(f"rules for {raw_kind!r} must be a mapping")
        for prefix, spec in body.items():
            level = spec.get("policy") if isinstance(spec, dict) else spec
            if level not in _LEVEL:
                raise ValueError(
                    f"invalid policy {level!r} for {raw_kind} {prefix!r}"
                )
            policy.rules[kind].append(Rule(prefix, level, exact=exact))
    return policy


class Authorizer:
    """Merged view of one or more policies (acl.NewPolicyAuthorizer).

    Match precedence per resource and name: the longest matching prefix
    wins (exact beats prefix at the same length); if several merged
    policies tie at the same specificity, DENY beats READ beats WRITE
    is NOT the rule — the reference takes the *most specific* rule and
    on exact ties the deny-est, which is what we do.
    """

    def __init__(self, policies: list[Policy], default: str = DENY):
        self.default = default
        self._rules: dict[str, list[Rule]] = {r: [] for r in PREFIX_RESOURCES}
        self._scalars: dict[str, str] = {}
        for p in policies:
            for kind, rules in p.rules.items():
                self._rules[kind].extend(rules)
            for kind, level in p.scalars.items():
                cur = self._scalars.get(kind)
                if cur is None or _LEVEL[level] < _LEVEL[cur]:
                    self._scalars[kind] = level  # deny-est wins on ties

    def _resolve(self, kind: str, name: str) -> str:
        best: Optional[Rule] = None
        for rule in self._rules[kind]:
            if rule.exact:
                if name != rule.prefix:
                    continue
            elif not name.startswith(rule.prefix):
                continue
            if best is None:
                best = rule
                continue
            # Specificity: exact > longer prefix; tie → deny-est.
            if (rule.exact, len(rule.prefix)) > (best.exact, len(best.prefix)):
                best = rule
            elif (rule.exact, len(rule.prefix)) == (
                best.exact, len(best.prefix)
            ) and _LEVEL[rule.policy] < _LEVEL[best.policy]:
                best = rule
        return best.policy if best else self.default

    def allowed(self, kind: str, name: str, want: str) -> bool:
        if kind in SCALAR_RESOURCES:
            level = self._scalars.get(kind, self.default)
        else:
            level = self._resolve(kind, name)
        return _LEVEL[level] >= _LEVEL[want]

    # Convenience wrappers matching the reference's Authorizer methods.
    def key_read(self, key: str) -> bool:
        return self.allowed("key", key, READ)

    def key_write(self, key: str) -> bool:
        return self.allowed("key", key, WRITE)

    def key_write_prefix(self, prefix: str) -> bool:
        """Write over an entire subtree (acl.go KeyWritePrefix): the
        prefix itself must resolve to write AND no configured key rule
        underneath it may grant less than write — otherwise a delete-tree
        on a parent could wipe an explicitly protected child."""
        if not self.allowed("key", prefix, WRITE):
            return False
        return all(
            _LEVEL[rule.policy] >= _LEVEL[WRITE]
            for rule in self._rules["key"]
            if rule.prefix.startswith(prefix)
        )

    def service_read(self, name: str) -> bool:
        return self.allowed("service", name, READ)

    def service_write(self, name: str) -> bool:
        return self.allowed("service", name, WRITE)

    def node_read(self, name: str) -> bool:
        return self.allowed("node", name, READ)

    def node_write(self, name: str) -> bool:
        return self.allowed("node", name, WRITE)

    def session_read(self, node: str) -> bool:
        return self.allowed("session", node, READ)

    def session_write(self, node: str) -> bool:
        return self.allowed("session", node, WRITE)

    def event_read(self, name: str) -> bool:
        return self.allowed("event", name, READ)

    def event_write(self, name: str) -> bool:
        return self.allowed("event", name, WRITE)

    def query_read(self, name: str) -> bool:
        return self.allowed("query", name, READ)

    def query_write(self, name: str) -> bool:
        return self.allowed("query", name, WRITE)

    def operator_read(self) -> bool:
        return self.allowed("operator", "", READ)

    def operator_write(self) -> bool:
        return self.allowed("operator", "", WRITE)

    def acl_read(self) -> bool:
        return self.allowed("acl", "", READ)

    def acl_write(self) -> bool:
        return self.allowed("acl", "", WRITE)


class _AllowAll(Authorizer):
    def __init__(self):
        super().__init__([], default=WRITE)


class _DenyAll(Authorizer):
    def __init__(self):
        super().__init__([], default=DENY)


class _Manage(Authorizer):
    """The management token: everything, including acl writes."""

    def __init__(self):
        super().__init__([], default=WRITE)
        self._scalars = {k: WRITE for k in SCALAR_RESOURCES}


ALLOW_ALL = _AllowAll()
DENY_ALL = _DenyAll()
MANAGE_ALL = _Manage()


def service_identity_policy(name: str) -> Policy:
    """Synthetic policy for a service identity
    (``agent/structs/acl.go`` ACLServiceIdentity.SyntheticPolicy):
    write on the service and its sidecar, read on everything needed
    for discovery."""
    return parse_policy({
        "service": {name: {"policy": WRITE},
                    f"{name}-sidecar-proxy": {"policy": WRITE}},
        "service_prefix": {"": {"policy": READ}},
        "node_prefix": {"": {"policy": READ}},
    })


def node_identity_policy(name: str) -> Policy:
    """Synthetic policy for a node identity
    (``agent/structs/acl.go`` ACLNodeIdentity.SyntheticPolicy)."""
    return parse_policy({
        "node": {name: {"policy": WRITE}},
        "service_prefix": {"": {"policy": READ}},
    })


def token_is_expired(token: dict, now: Optional[float] = None) -> bool:
    """``agent/structs/acl.go`` ACLToken.IsExpired — wall-clock
    ``expiration_time`` (unix seconds) already passed."""
    exp = token.get("expiration_time")
    if not exp:
        return False
    return (time.time() if now is None else now) >= float(exp)


class ACLResolver:
    """Token secret → Authorizer, with TTL caching
    (agent/consul/acl.go ACLResolver)."""

    def __init__(
        self,
        token_lookup: Callable[[str], Optional[dict]],
        policy_lookup: Callable[[str], Optional[dict]],
        enabled: bool = False,
        default_policy: str = "allow",
        master_token: str = "",
        ttl_s: float = 30.0,
        role_lookup: Optional[Callable[[str], Optional[dict]]] = None,
    ):
        self.token_lookup = token_lookup
        self.policy_lookup = policy_lookup
        self.role_lookup = role_lookup
        self.enabled = enabled
        self.default_policy = default_policy
        self.master_token = master_token
        self.ttl_s = ttl_s
        self._cache: dict[str, tuple[float, Authorizer]] = {}

    def _token_policies(self, token: dict) -> list[Policy]:
        """Expand policies + role→policy links + service/node identities
        (consul/acl.go resolveTokenToIdentityAndPolicies: tokens link
        policies directly, through roles, and through identities)."""
        policy_ids = list(token.get("policies", []))
        identities = [
            ("service", s) for s in token.get("service_identities", [])
        ] + [("node", n) for n in token.get("node_identities", [])]
        if self.role_lookup is not None:
            for rid in token.get("roles", []):
                role = self.role_lookup(rid)
                if role is None:
                    continue
                policy_ids.extend(role.get("policies", []))
                identities.extend(
                    ("service", s)
                    for s in role.get("service_identities", [])
                )
                identities.extend(
                    ("node", n) for n in role.get("node_identities", [])
                )
        policies = []
        for pid in policy_ids:
            rec = self.policy_lookup(pid)
            if rec is not None:
                policies.append(parse_policy(rec.get("rules", "{}")))
        for kind, ident in identities:
            name = (
                ident.get("service_name" if kind == "service"
                          else "node_name", "")
                if isinstance(ident, dict) else str(ident)
            )
            if name:
                policies.append(
                    service_identity_policy(name) if kind == "service"
                    else node_identity_policy(name)
                )
        return policies

    def resolve(self, secret: str) -> Authorizer:
        """consul/acl.go ResolveToken."""
        if not self.enabled:
            return ALLOW_ALL
        if self.master_token and secret == self.master_token:
            return MANAGE_ALL
        if not secret:  # anonymous
            return ALLOW_ALL if self.default_policy == "allow" else DENY_ALL
        now = time.monotonic()
        cached = self._cache.get(secret)
        if cached and now < cached[0]:
            return cached[1]
        token = self.token_lookup(secret)
        if token is None:
            raise ACLError("ACL not found")
        if token_is_expired(token):
            # acl_token_exp.go: expired tokens behave exactly like
            # deleted ones even before the reaper collects them.
            raise ACLError("ACL not found")
        if token.get("type") == "management":
            authz: Authorizer = MANAGE_ALL
        else:
            default = WRITE if self.default_policy == "allow" else DENY
            authz = Authorizer(self._token_policies(token), default=default)
        ttl = self.ttl_s
        exp = token.get("expiration_time")
        if exp:
            # Never cache past the token's own expiry.
            ttl = min(ttl, max(0.0, float(exp) - time.time()))
        self._cache[secret] = (now + ttl, authz)
        return authz

    def invalidate(self, secret: str = "") -> None:
        if secret:
            self._cache.pop(secret, None)
        else:
            self._cache.clear()
