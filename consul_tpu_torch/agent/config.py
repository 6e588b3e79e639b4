"""Config system: files + flags → a frozen, validated RuntimeConfig; the
port's copy of ``consul_tpu/agent/config.py``.

Equivalent of ``agent/config`` (SURVEY.md §2.3): any number of config
files (JSON, or the HCL subset below) plus CLI flags are merged in
order — later sources win scalars, list-valued fields append — then
validated into an immutable :class:`RuntimeConfig`
(``config/builder.go``, ``runtime.go``, ``default.go``).  Gossip tuning
is exposed as ``gossip_lan`` / ``gossip_wan`` blocks layered over the
built-in LAN/WAN profiles (``config/default.go`` GossipLANConfig).

Partial reload (``agent.go reloadConfigInternal``): service/check
definitions and a small set of runtime knobs can change on SIGHUP;
identity and cluster topology fields cannot — :func:`reloadable_diff`
separates the two.

HCL subset grammar (enough for the reference's common config shapes):

    key = "value"            # string / number / true / false
    key = [ "a", "b" ]       # lists
    block_name {             # nested object
        inner = 1
    }
    # comments and // comments
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Any, Optional

from consul_tpu_torch.protocol.profiles import LAN, WAN, GossipProfile

# Fields whose list values APPEND across sources (builder.go merge).
_APPEND_FIELDS = {"services", "checks", "retry_join", "retry_join_wan"}

# Fields that may change on reload (agent.go reloadConfigInternal:
# services, checks, and a few runtime knobs; everything else requires a
# restart).
RELOADABLE = {
    "services", "checks", "dns_only_passing", "dns_node_ttl_s",
    "dns_recursors", "log_level",
}

_GOSSIP_TUNABLES = (
    "gossip_interval_ms", "probe_interval_ms", "probe_timeout_ms",
    "suspicion_mult", "retransmit_mult", "gossip_nodes",
    "push_pull_interval_ms", "indirect_checks",
)


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """The validated, immutable runtime configuration
    (``config/runtime.go`` RuntimeConfig)."""

    node_name: str = "node"
    datacenter: str = "dc1"
    server: bool = False
    bootstrap_expect: int = 1
    # Persistence root: the serf gossip snapshot lives at
    # <data_dir>/serf/local.snapshot (config "data_dir").
    data_dir: str = ""
    rejoin_after_leave: bool = False
    # WAN replication (secondary DCs pull from the primary).
    primary_datacenter: str = ""
    acl_replication_token: str = ""
    bind_addr: str = "127.0.0.1"
    ports_http: int = 8500
    ports_dns: int = 8600
    ports_serf_lan: int = 8301
    ports_serf_wan: int = 8302
    ports_server: int = 8300
    retry_join: tuple = ()
    retry_join_wan: tuple = ()
    log_level: str = "info"
    # Gossip encryption key, base64 (config "encrypt"; consul keygen).
    encrypt: str = ""
    # Gossip tuning blocks (resolved to profiles via gossip_profile()).
    gossip_lan: tuple = ()   # ((key, value), ...) hashable overrides
    gossip_wan: tuple = ()
    # ACL block.
    acl_enabled: bool = False
    acl_default_policy: str = "allow"
    acl_master_token: str = ""
    acl_agent_token: str = ""
    # Agent behavior.
    enable_script_checks: bool = False
    dns_only_passing: bool = True
    dns_node_ttl_s: float = 0.0
    # Upstream resolvers for non-.consul names (config "recursors").
    dns_recursors: tuple = ()
    # auto_config (agent/auto-config/config.go): client bootstrap via a
    # JWT intro token; servers hold the authorizer spec.
    auto_config_enabled: bool = False
    auto_config_intro_token: str = ""
    auto_config_server_addresses: tuple = ()
    auto_config_authorizer: object = None
    reconcile_interval_s: float = 60.0
    sync_interval_s: float = 60.0
    gossip_interval_scale: float = 1.0
    # Service/check definitions from config files (agent/structs
    # ServiceDefinition / CheckDefinition as plain dicts).
    services: tuple = ()
    checks: tuple = ()

    def gossip_profile(self, wan: bool = False) -> GossipProfile:
        """LAN/WAN base profile + the tuning block's overrides
        (config/default.go GossipLANConfig/GossipWANConfig)."""
        base = WAN if wan else LAN
        overrides = dict(self.gossip_wan if wan else self.gossip_lan)
        if not overrides:
            return base
        return dataclasses.replace(base, **overrides)


class ConfigError(ValueError):
    """Invalid or unknown configuration (builder.go Validate)."""


# ---------------------------------------------------------------------------
# HCL subset parser
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    \s*(?:
        (?P<comment>\#[^\n]*|//[^\n]*)
      | (?P<lbrace>\{) | (?P<rbrace>\})
      | (?P<lbrack>\[) | (?P<rbrack>\])
      | (?P<eq>=) | (?P<comma>,)
      | (?P<string>"(?:[^"\\]|\\.)*")
      | (?P<number>-?\d+(?:\.\d+)?)
      | (?P<bool>true|false)
      | (?P<ident>[A-Za-z_][A-Za-z0-9_.-]*)
    )
    """,
    re.VERBOSE,
)


def _tokenize_hcl(src: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            if src[pos:].strip() == "":
                break
            raise ConfigError(f"bad HCL at offset {pos}: {src[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind and kind != "comment":
            out.append((kind, m.group(kind)))
    return out


def parse_hcl(src: str) -> dict:
    """Parse the HCL subset into a dict (hcl/hcl parser's JSON view)."""
    tokens = _tokenize_hcl(src)
    pos = 0

    def parse_value():
        nonlocal pos
        kind, text = tokens[pos]
        if kind == "string":
            pos += 1
            return json.loads(text)
        if kind == "number":
            pos += 1
            return float(text) if "." in text else int(text)
        if kind == "bool":
            pos += 1
            return text == "true"
        if kind == "lbrack":
            pos += 1
            items = []
            while tokens[pos][0] != "rbrack":
                items.append(parse_value())
                if tokens[pos][0] == "comma":
                    pos += 1
            pos += 1
            return items
        if kind == "lbrace":
            return parse_object()
        raise ConfigError(f"unexpected HCL token {text!r}")

    def parse_object():
        nonlocal pos
        assert tokens[pos][0] == "lbrace"
        pos += 1
        obj: dict = {}
        while tokens[pos][0] != "rbrace":
            obj.update(parse_entry())
        pos += 1
        return obj

    def parse_entry():
        nonlocal pos
        kind, text = tokens[pos]
        if kind not in ("ident", "string"):
            raise ConfigError(f"expected key, got {text!r}")
        key = json.loads(text) if kind == "string" else text
        pos += 1
        kind, _ = tokens[pos]
        if kind == "eq":
            pos += 1
            return {key: parse_value()}
        if kind == "lbrace":
            # `services { ... }` block syntax: repeated blocks of the
            # same name accumulate into a list (hcl list semantics).
            return {key: parse_object()}
        raise ConfigError(f"expected '=' or block after {key!r}")

    out: dict = {}
    accumulate = _APPEND_FIELDS | {"service", "check"}
    while pos < len(tokens):
        for key, value in parse_entry().items():
            if key in out and key in accumulate:
                prev = out[key]
                prev = prev if isinstance(prev, list) else [prev]
                nxt = value if isinstance(value, list) else [value]
                out[key] = prev + nxt
            else:
                out[key] = value
    return out


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

_FIELDS = {f.name: f for f in dataclasses.fields(RuntimeConfig)}

# Nested block spellings accepted from files (builder.go mapping of the
# reference's config JSON shapes onto flat runtime fields).
_BLOCKS = {
    "acl": {
        "enabled": "acl_enabled",
        "default_policy": "acl_default_policy",
        "tokens.master": "acl_master_token",
        "tokens.agent": "acl_agent_token",
    },
    "dns_config": {
        "only_passing": "dns_only_passing",
        "node_ttl_s": "dns_node_ttl_s",
        "recursors": "dns_recursors",
    },
    "auto_config": {
        "enabled": "auto_config_enabled",
        "intro_token": "auto_config_intro_token",
        "server_addresses": "auto_config_server_addresses",
        "authorization": "auto_config_authorizer",
    },
    "ports": {
        "http": "ports_http",
        "dns": "ports_dns",
        "serf_lan": "ports_serf_lan",
        "serf_wan": "ports_serf_wan",
        "server": "ports_server",
    },
}


def _flatten(raw: dict, source: str) -> dict:
    """One file/flag dict → flat {runtime_field: value}."""
    flat: dict = {}
    for key, value in raw.items():
        if key in ("gossip_lan", "gossip_wan"):
            if not isinstance(value, dict):
                raise ConfigError(f"{source}: {key} must be a block")
            unknown = set(value) - set(_GOSSIP_TUNABLES)
            if unknown:
                raise ConfigError(
                    f"{source}: unknown {key} tunables {sorted(unknown)}"
                )
            flat[key] = tuple(sorted(value.items()))
            continue
        if key in _BLOCKS:
            if not isinstance(value, dict):
                raise ConfigError(f"{source}: {key} must be a block")
            mapping = _BLOCKS[key]
            for sub, subval in value.items():
                if sub in mapping:
                    # Direct mapping wins — a dict value here is the
                    # field's value wholesale (auto_config.authorization).
                    flat[mapping[sub]] = subval
                elif isinstance(subval, dict):
                    for s2, v2 in subval.items():
                        field = mapping.get(f"{sub}.{s2}")
                        if field is None:
                            raise ConfigError(
                                f"{source}: unknown key {key}.{sub}.{s2}"
                            )
                        flat[field] = v2
                else:
                    raise ConfigError(f"{source}: unknown key {key}.{sub}")
            continue
        if key in ("service", "check"):
            field = "services" if key == "service" else "checks"
            items = value if isinstance(value, list) else [value]
            flat[field] = list(flat.get(field, [])) + items
            continue
        if key not in _FIELDS:
            raise ConfigError(f"{source}: unknown configuration key {key!r}")
        flat[key] = value
    return flat


class Builder:
    """config/builder.go Builder: sources in, RuntimeConfig out."""

    def __init__(self) -> None:
        self._sources: list[tuple[str, dict]] = []

    def add_file(self, path: str | Path) -> "Builder":
        path = Path(path)
        text = path.read_text()
        if path.suffix == ".json":
            raw = json.loads(text or "{}")
        elif path.suffix == ".hcl":
            raw = parse_hcl(text)
        else:
            # Sniff: JSON object vs HCL (builder.go tries both).
            try:
                raw = json.loads(text)
            except json.JSONDecodeError:
                raw = parse_hcl(text)
        self._sources.append((str(path), raw))
        return self

    def add_dir(self, path: str | Path) -> "Builder":
        """Config dir: *.json + *.hcl in lexical order (builder.go)."""
        for p in sorted(Path(path).iterdir()):
            if p.suffix in (".json", ".hcl"):
                self.add_file(p)
        return self

    def add_flags(self, flags: dict) -> "Builder":
        """CLI flags merge LAST (highest precedence, builder.go)."""
        self._sources.append(("flags", {
            k: v for k, v in flags.items() if v is not None
        }))
        return self

    def build(self) -> RuntimeConfig:
        merged: dict = {}
        for source, raw in self._sources:
            flat = _flatten(raw, source)
            for key, value in flat.items():
                if key in _APPEND_FIELDS:
                    merged[key] = tuple(merged.get(key, ())) + tuple(
                        value if isinstance(value, (list, tuple)) else [value]
                    )
                else:
                    merged[key] = value
        # Freeze nested dicts (service/check definitions) for hashing.
        for key in ("services", "checks"):
            if key in merged:
                merged[key] = tuple(
                    _freeze(v) for v in merged[key]
                )
        for key in ("dns_recursors", "auto_config_server_addresses"):
            if key in merged:
                v = merged[key]
                merged[key] = tuple(
                    v if isinstance(v, (list, tuple)) else [v]
                )
        rc = RuntimeConfig(**merged)
        _validate(rc)
        return rc


def _freeze(value):
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    if isinstance(value, list):
        return tuple(_freeze(v) for v in value)
    return value


def thaw(value):
    """Inverse of _freeze for consumers that want plain dicts."""
    if isinstance(value, tuple) and all(
        isinstance(i, tuple) and len(i) == 2 and isinstance(i[0], str)
        for i in value
    ) and value:
        return {k: thaw(v) for k, v in value}
    if isinstance(value, tuple):
        return [thaw(v) for v in value]
    return value


def _validate(rc: RuntimeConfig) -> None:
    """builder.go Validate: the checks that catch real foot-guns."""
    if not rc.node_name:
        raise ConfigError("node_name must not be empty")
    if rc.bootstrap_expect < 1:
        raise ConfigError("bootstrap_expect must be >= 1")
    if rc.bootstrap_expect > 1 and not rc.server:
        raise ConfigError("bootstrap_expect requires server mode")
    if rc.acl_default_policy not in ("allow", "deny"):
        raise ConfigError(
            f"acl default_policy must be allow|deny, got "
            f"{rc.acl_default_policy!r}"
        )
    for blk in (rc.gossip_lan, rc.gossip_wan):
        for key, value in blk:
            if not isinstance(value, (int, float)) or value <= 0:
                raise ConfigError(f"gossip tunable {key} must be positive")
    for svc in rc.services:
        if not dict(svc).get("service") and not dict(svc).get("name"):
            raise ConfigError("service definition needs a name")
    for chk in rc.checks:
        d = dict(chk)
        if not (d.get("ttl") or d.get("http") or d.get("tcp")
                or d.get("script") or d.get("args")):
            raise ConfigError(
                "check definition needs ttl/http/tcp/script"
            )


def reloadable_diff(old: RuntimeConfig, new: RuntimeConfig) -> dict:
    """Split a config change into what reload can apply.

    Returns {field: new_value} for changed RELOADABLE fields; raises
    ConfigError listing changed non-reloadable fields (the reference
    logs and ignores them; failing loudly is kinder)."""
    changed_fixed = []
    apply: dict = {}
    for f in dataclasses.fields(RuntimeConfig):
        ov, nv = getattr(old, f.name), getattr(new, f.name)
        if ov == nv:
            continue
        if f.name in RELOADABLE:
            apply[f.name] = nv
        else:
            changed_fixed.append(f.name)
    if changed_fixed:
        raise ConfigError(
            "non-reloadable fields changed (restart required): "
            + ", ".join(sorted(changed_fixed))
        )
    return apply
