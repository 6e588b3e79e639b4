"""Discovery-chain compiler: config entries → a routing graph; the port's
copy of ``consul_tpu/connect/discoverychain.py``.

Re-design of ``agent/consul/discoverychain/compile.go:56`` (Compile):
three config-entry kinds assemble into a graph consumed by the proxy
config plane and by service reads —

  service-router    L7 match rules → destinations (top of chain only,
                    compile.go:499 assembleChain)
  service-splitter  weighted traffic splits (compile.go:682)
  service-resolver  redirects, named subsets, default subset, per-subset
                    failover targets, connect timeout (compile.go:763)

plus ``service-defaults`` (protocol, external SNI) and
``proxy-defaults`` (global protocol fallback).

The compiled chain is a plain dict:

    {"service_name": str, "datacenter": str, "protocol": str,
     "start_node": node_key,
     "nodes":   {node_key: node_dict},
     "targets": {target_id: target_dict}}

Node keys are ``<type>:<name>``; target ids are
``<service>[:<subset>]@<dc>`` (our spelling of the reference's
``subset.service.namespace.dc`` DiscoveryTarget.ID — no namespaces in
this build, OSS semantics).

Behavioral parity pinned by tests/test_discoverychain.py against the
reference's compile_test.go golden cases: default chain, redirect,
circular-redirect error, default-subset, failover expansion, splitter
flattening, router catch-all route, L7-protocol gating, unknown-subset
and external-SNI validation errors.

Deviations (documented, deliberate): no namespaces/enterprise meta, no
hash-based load-balancer policy propagation, mesh-gateway mode is
recorded on targets but only ``default``/``remote``/``local`` strings
(no gateway endpoint rewriting here — that is the gateway locator's
job).
"""

from __future__ import annotations

from typing import Optional

DEFAULT_CONNECT_TIMEOUT_S = 5.0  # compile.go:848

# Protocols that permit routers/splitters (compile.go
# enableAdvancedRoutingForProtocol → structs.IsProtocolHTTPLike).
_L7_PROTOCOLS = ("http", "http2", "grpc")


class ChainCompileError(ValueError):
    """structs.ConfigEntryGraphError."""


def is_l7(protocol: str) -> bool:
    return protocol in _L7_PROTOCOLS


def target_id(service: str, subset: str, dc: str) -> str:
    return f"{service}:{subset}@{dc}" if subset else f"{service}@{dc}"


class _Compiler:
    """Single-use state for one compile (compile.go compiler struct)."""

    def __init__(self, service: str, datacenter: str, entries: dict,
                 use_in_datacenter: str, override_protocol: str,
                 override_connect_timeout_s: float):
        self.service = service
        self.dc = datacenter
        self.use_in_dc = use_in_datacenter or datacenter
        self.entries = entries or {}
        self.override_protocol = override_protocol
        self.override_connect_timeout_s = override_connect_timeout_s

        self.nodes: dict[str, dict] = {}
        self.targets: dict[str, dict] = {}
        self.retained: set[str] = set()
        self.protocol: str = ""
        self.uses_advanced = False
        self.start_node = ""
        # With an L4 override the chain must not include routers or
        # splitters (CompileRequest.OverrideProtocol contract).
        self.disable_advanced = bool(
            override_protocol and not is_l7(override_protocol)
        )

    # -- config-entry lookups ------------------------------------------

    def _resolver(self, service: str) -> dict:
        rec = (self.entries.get("resolvers") or {}).get(service)
        return rec if rec is not None else {"name": service, "default": True}

    def _splitter(self, service: str) -> Optional[dict]:
        if self.disable_advanced:
            return None
        return (self.entries.get("splitters") or {}).get(service)

    def _router(self, service: str) -> Optional[dict]:
        if self.disable_advanced:
            return None
        return (self.entries.get("routers") or {}).get(service)

    def _service_defaults(self, service: str) -> dict:
        return (self.entries.get("services") or {}).get(service) or {}

    def _global_proxy(self) -> dict:
        return self.entries.get("global_proxy") or {}

    # -- protocol discipline (compile.go:211-250) ----------------------

    def _record_protocol(self, service: str) -> None:
        proto = (
            self._service_defaults(service).get("protocol")
            or (self._global_proxy().get("config") or {}).get("protocol")
            or self._global_proxy().get("protocol")
            or "tcp"
        )
        if not self.protocol:
            self.protocol = proto
        elif self.protocol != proto:
            raise ChainCompileError(
                f"discovery chain {self.service!r} crosses services using "
                f"different protocols ({self.protocol!r} then {proto!r} at "
                f"{service!r}); change the upstream references or align "
                "the protocols"
            )

    # -- targets -------------------------------------------------------

    def _new_target(self, service: str, subset: str, dc: str) -> dict:
        tid = target_id(service, subset, dc or self.dc)
        if tid not in self.targets:
            self.targets[tid] = {
                "id": tid,
                "service": service,
                "subset": subset,
                "datacenter": dc or self.dc,
                "mesh_gateway": "default",
                "external": False,
                "sni": "",
            }
        return self.targets[tid]

    def _rewrite_target(self, t: dict, service: str, subset: str,
                        dc: str) -> dict:
        """compile.go:646 rewriteTarget: referencing another service
        resets the chosen subset."""
        svc, sub, d = t["service"], t["subset"], t["datacenter"]
        if service and service != svc:
            svc, sub = service, ""
        if subset:
            sub = subset
        if dc:
            d = dc
        return self._new_target(svc, sub, d)

    # -- graph assembly ------------------------------------------------

    def compile(self) -> dict:
        self._assemble()
        self._detect_cycles()
        self._flatten_adjacent_splitters()
        self._remove_unused()
        self.targets = {
            tid: t for tid, t in self.targets.items() if tid in self.retained
        }
        if self.uses_advanced and not is_l7(self.protocol):
            raise ChainCompileError(
                f"discovery chain {self.service!r} uses a protocol "
                f"{self.protocol!r} that does not permit advanced routing "
                "or splitting behavior"
            )
        if self.override_protocol:
            self.protocol = self.override_protocol
        return {
            "service_name": self.service,
            "datacenter": self.dc,
            "protocol": self.protocol,
            "start_node": self.start_node,
            "nodes": self.nodes,
            "targets": self.targets,
        }

    def _assemble(self) -> None:
        router = self._router(self.service)
        if router is None:
            node = self._splitter_or_resolver(
                self._new_target(self.service, "", ""))
            self.start_node = node["key"]
            return

        self._record_protocol(self.service)
        self.uses_advanced = True
        routes = []
        for route in router.get("routes", []):
            dest = route.get("destination") or {}
            svc = dest.get("service") or self.service
            subset = dest.get("service_subset", "")
            dc = dest.get("datacenter", "")
            if subset:
                nxt = self._resolver_node(
                    self._new_target(svc, subset, dc), for_failover=False)
            else:
                nxt = self._splitter_or_resolver(
                    self._new_target(svc, "", dc))
            routes.append({"definition": route, "next_node": nxt["key"]})
        # Catch-all route to the router's own service (compile.go:585).
        default_next = self._splitter_or_resolver(
            self._new_target(self.service, "", ""))
        routes.append({
            "definition": {"match": {"http": {"path_prefix": "/"}},
                           "destination": {"service": self.service}},
            "next_node": default_next["key"],
        })
        node = {"type": "router", "name": self.service,
                "key": f"router:{self.service}", "routes": routes}
        self.nodes[node["key"]] = node
        self.start_node = node["key"]

    def _splitter_or_resolver(self, target: dict) -> dict:
        node = self._splitter_node(target["service"])
        if node is not None:
            return node
        return self._resolver_node(target, for_failover=False)

    def _splitter_node(self, service: str) -> Optional[dict]:
        key = f"splitter:{service}"
        if key in self.nodes:
            return self.nodes[key]
        splitter = self._splitter(service)
        if splitter is None:
            return None
        self._record_protocol(service)
        node = {"type": "splitter", "name": service, "key": key,
                "splits": []}
        # Record before recursing so graph loops short-circuit
        # (compile.go:708).
        self.nodes[key] = node
        self.uses_advanced = True
        for split in splitter.get("splits", []):
            svc = split.get("service") or service
            subset = split.get("service_subset", "")
            if svc != service and not subset:
                nxt = self._splitter_node(svc)
                if nxt is not None:
                    node["splits"].append({"weight": split.get("weight", 0),
                                           "next_node": nxt["key"]})
                    continue
            res = self._resolver_node(
                self._new_target(svc, subset, ""), for_failover=False)
            node["splits"].append({"weight": split.get("weight", 0),
                                   "next_node": res["key"]})
        return node

    def _resolver_node(self, target: dict, for_failover: bool) -> dict:
        """compile.go:763 getResolverNode: redirects and default-subset
        rewrites loop back through resolution; failover recurses with
        for_failover=True to reuse that logic for target generation."""
        redirect_history: list[str] = []

        while True:
            key = f"resolver:{target['id']}"
            if key in self.nodes and not for_failover:
                return self.nodes[key]
            self._record_protocol(target["service"])
            resolver = self._resolver(target["service"])

            if target["id"] in redirect_history:
                chain = " -> ".join(redirect_history + [target["id"]])
                raise ChainCompileError(
                    f"detected circular resolver redirect: [{chain}]")
            redirect_history.append(target["id"])

            redirect = resolver.get("redirect")
            if redirect:
                nxt = self._rewrite_target(
                    target,
                    redirect.get("service", ""),
                    redirect.get("service_subset", ""),
                    redirect.get("datacenter", ""),
                )
                if nxt["id"] != target["id"]:
                    target = nxt
                    continue
            if not target["subset"] and resolver.get("default_subset"):
                target = self._rewrite_target(
                    target, "", resolver["default_subset"], "")
                continue
            break

        subsets = resolver.get("subsets") or {}
        if target["subset"] and target["subset"] not in subsets:
            raise ChainCompileError(
                f"service {target['service']!r} does not have a subset "
                f"named {target['subset']!r}")

        timeout = float(resolver.get("connect_timeout_s", 0) or 0)
        if timeout <= 0:
            timeout = DEFAULT_CONNECT_TIMEOUT_S
        if self.override_connect_timeout_s > 0:
            timeout = self.override_connect_timeout_s

        target["filter"] = (subsets.get(target["subset"]) or {}).get(
            "filter", "") if target["subset"] else ""
        target["only_passing"] = bool(
            (subsets.get(target["subset"]) or {}).get("only_passing", False)
        ) if target["subset"] else False

        defaults = self._service_defaults(target["service"])
        if defaults.get("external_sni"):
            target["sni"] = defaults["external_sni"]
            target["external"] = True
            for field, label in (("redirect", "redirects"),
                                 ("subsets", "subsets"),
                                 ("failover", "failover")):
                if resolver.get(field):
                    raise ChainCompileError(
                        f"service {target['service']!r} has an external SNI "
                        f"set; cannot define {label} for external services")

        # Mesh-gateway mode: per-service default, then proxy-defaults
        # (compile.go:905-930); local-dc targets need no gateway.
        if target["datacenter"] != self.use_in_dc and not target["external"]:
            mode = defaults.get("mesh_gateway") or \
                self._global_proxy().get("mesh_gateway") or "default"
            target["mesh_gateway"] = mode

        key = f"resolver:{target['id']}"
        node = {
            "type": "resolver", "name": target["id"], "key": key,
            "resolver": {
                "default": bool(resolver.get("default")),
                "target": target["id"],
                "connect_timeout_s": timeout,
                "failover": None,
            },
        }
        self.retained.add(target["id"])
        if for_failover:
            # Emitted for target generation only — not cached, and
            # failover does not nest (compile.go:934-940).
            return node
        self.nodes[key] = node

        failover_map = resolver.get("failover") or {}
        failover = failover_map.get(target["subset"] or "",
                                    failover_map.get("*"))
        if failover:
            fo_targets = []
            dcs = failover.get("datacenters") or [""]
            for dc in dcs:
                ft = self._rewrite_target(
                    target,
                    failover.get("service", ""),
                    failover.get("service_subset", ""),
                    dc,
                )
                if ft["id"] != target["id"]:  # don't fail over to yourself
                    fo_targets.append(ft)
            resolved = []
            for ft in fo_targets:
                fnode = self._resolver_node(ft, for_failover=True)
                resolved.append(fnode["resolver"]["target"])
            if resolved:
                node["resolver"]["failover"] = {"targets": resolved}
        return node

    # -- post passes (compile.go:333-497) ------------------------------

    def _detect_cycles(self) -> None:
        """compile.go:333 detectCircularReferences: a splitter graph
        loop (allowed to form by the record-before-recurse
        short-circuit) must fail the compile, not hang the flatten
        pass — this runs synchronously on the server event loop."""
        in_stack: list[str] = []
        done: set[str] = set()

        def edges(node: dict) -> list[str]:
            if node["type"] == "router":
                return [r["next_node"] for r in node["routes"]]
            if node["type"] == "splitter":
                return [s["next_node"] for s in node["splits"]]
            return []

        def visit(key: str) -> None:
            if key in in_stack:
                chain = " -> ".join(in_stack[in_stack.index(key):] + [key])
                raise ChainCompileError(
                    f"detected circular reference: [{chain}]")
            node = self.nodes.get(key)
            if node is None or key in done:
                return
            in_stack.append(key)
            for nxt in edges(node):
                visit(nxt)
            in_stack.pop()
            done.add(key)

        visit(self.start_node)

    def _flatten_adjacent_splitters(self) -> None:
        """splitter→splitter edges inline the child's splits, scaling
        weights (compile.go:388 flattenAdjacentSplitterNodes)."""
        changed = True
        while changed:
            changed = False
            for node in self.nodes.values():
                if node["type"] != "splitter":
                    continue
                flat = []
                for split in node["splits"]:
                    child = self.nodes.get(split["next_node"])
                    if child is not None and child["type"] == "splitter":
                        for sub in child["splits"]:
                            flat.append({
                                "weight": round(
                                    split["weight"] * sub["weight"] / 100.0,
                                    2),
                                "next_node": sub["next_node"],
                            })
                        changed = True
                    else:
                        flat.append(split)
                node["splits"] = flat

    def _remove_unused(self) -> None:
        seen: set[str] = set()
        frontier = [self.start_node]
        while frontier:
            key = frontier.pop()
            if key in seen or key not in self.nodes:
                continue
            seen.add(key)
            node = self.nodes[key]
            if node["type"] == "router":
                frontier += [r["next_node"] for r in node["routes"]]
            elif node["type"] == "splitter":
                frontier += [s["next_node"] for s in node["splits"]]
        self.nodes = {k: v for k, v in self.nodes.items() if k in seen}
        self.retained = {
            n["resolver"]["target"]
            for n in self.nodes.values() if n["type"] == "resolver"
        } | {
            t
            for n in self.nodes.values() if n["type"] == "resolver"
            and n["resolver"]["failover"]
            for t in n["resolver"]["failover"]["targets"]
        }


def compile_chain(service: str, datacenter: str, entries: dict,
                  use_in_datacenter: str = "",
                  override_protocol: str = "",
                  override_connect_timeout_s: float = 0.0) -> dict:
    """Assemble one service's discovery chain (compile.go:56 Compile).

    ``entries`` carries the relevant config entries, pre-indexed:
    ``{"resolvers": {name: entry}, "splitters": {...}, "routers": {...},
    "services": {name: service-defaults}, "global_proxy": proxy-defaults
    entry}`` — the shape ``entries_for_chain`` builds from the state
    store.
    """
    if not service:
        raise ChainCompileError("service name is required")
    return _Compiler(service, datacenter, entries, use_in_datacenter,
                     override_protocol, override_connect_timeout_s).compile()


def entries_for_chain(store, service: str, ws=None) -> tuple[int, dict]:
    """Gather the config entries a chain compile needs from the state
    store, in ONE table read that also registers the caller's watch
    (discoverychain/gateway.go ReadDiscoveryChainConfigEntries,
    collapsed: we read all entries of the relevant kinds — entry counts
    are small and the store read is index-consistent)."""
    out = {"resolvers": {}, "splitters": {}, "routers": {}, "services": {},
           "global_proxy": None}
    kind_slot = {"service-resolver": "resolvers",
                 "service-splitter": "splitters",
                 "service-router": "routers",
                 "service-defaults": "services"}
    idx, recs = store.config_entries_by_kind(None, ws=ws)
    for rec in recs:
        slot = kind_slot.get(rec.get("kind"))
        if slot is not None:
            out[slot][rec["name"]] = rec
        elif rec.get("kind") == "proxy-defaults":
            out["global_proxy"] = rec
    return idx, out
