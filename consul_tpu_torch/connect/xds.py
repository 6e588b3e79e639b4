"""ADS-shaped config export: proxycfg snapshots → Envoy-style resources;
the port's copy of ``consul_tpu/connect/xds.py``.

Re-design of ``agent/xds/`` (server.go:1-494 + clusters.go,
endpoints.go, listeners.go, routes.go, rbac.go, naming.go): the
reference streams protobuf DiscoveryResponses over gRPC to Envoy; here
the same four resource families are assembled as plain JSON-shaped
dicts carrying the v2 type URLs, exported over the agent's HTTP plane
(``/v1/agent/connect/proxy/<id>/xds``, blocking like the plain
snapshot feed).  Anything that speaks "cluster/endpoint/listener/route"
can consume it; the golden tests (tests/test_xds.py vs
tests/golden/*.json) pin the structures the way
``agent/xds/golden_test.go`` pins the reference's testdata.

Kept faithfully from the reference:
  naming      ``<subset>.<service>.default.<dc>.internal.<trust-domain>``
              cluster/SNI names (connect/sni.go ServiceSNI), the
              ``local_app`` cluster and ``public_listener``
              (listeners.go:107,555)
  clusters    one EDS-style cluster per chain target with connect
              timeout and TLS context pinning the target SNI + CA roots
  endpoints   ClusterLoadAssignment per cluster from the snapshot's
              health-watched (or gateway-routed) instances
  listeners   public listener (TLS + RBAC network filter from
              intentions) + one outbound listener per upstream
              (tcp_proxy for L4, http_connection_manager + RDS for
              http-protocol chains)
  routes      RouteConfiguration per http upstream compiled from the
              chain's router/splitter nodes (routes.go
              routesFromSnapshot)
  rbac        intention list → RBAC policies: precedence order, exact
              sources beat wildcard, same-source lower precedence
              dropped, principals as SPIFFE URI regexes (rbac.go
              makeRBACNetworkFilter + intentionListToIntermediateRBACForm)
"""

from __future__ import annotations

from typing import Any, Optional

CLUSTER_TYPE = "type.googleapis.com/envoy.api.v2.Cluster"
ENDPOINT_TYPE = "type.googleapis.com/envoy.api.v2.ClusterLoadAssignment"
LISTENER_TYPE = "type.googleapis.com/envoy.api.v2.Listener"
ROUTE_TYPE = "type.googleapis.com/envoy.api.v2.RouteConfiguration"

LOCAL_APP_CLUSTER = "local_app"
PUBLIC_LISTENER = "public_listener"


# ---------------------------------------------------------------------------
# naming (connect/sni.go + xds/naming.go)
# ---------------------------------------------------------------------------


def trust_domain_from_roots(snap: dict) -> str:
    for root in snap.get("roots") or []:
        if root.get("trust_domain"):
            return root["trust_domain"]
    return "consul"


def target_sni(target: dict, trust_domain: str) -> str:
    """connect/sni.go ServiceSNI / the target's pre-computed external
    SNI."""
    if target.get("sni"):
        return target["sni"]
    parts = [target["service"], "default", target["datacenter"],
             "internal", trust_domain]
    if target.get("subset"):
        parts.insert(0, target["subset"])
    return ".".join(parts)


def _target_cluster_name(tid: str, target: dict, trust_domain: str) -> str:
    # The reference names chain clusters by their SNI (clusters.go
    # makeUpstreamClusterForDiscoveryChain).
    return target_sni(target, trust_domain)


# ---------------------------------------------------------------------------
# RBAC (rbac.go)
# ---------------------------------------------------------------------------


def _spiffe_principal(source: str, trust_domain: str) -> dict:
    """rbac.go makeSpiffePattern: a source intention becomes a SPIFFE
    URI principal; '*' covers every service in the trust domain."""
    svc = "[^/]+" if source == "*" else source
    regex = f"^spiffe://{trust_domain}/ns/[^/]+/dc/[^/]+/svc/{svc}$"
    return {
        "authenticated": {
            "principal_name": {"safe_regex": {"regex": regex}}
        }
    }


def rbac_rules_from_intentions(
    intentions: list[dict], default_allow: bool, trust_domain: str
) -> dict:
    """rbac.go makeRBACRules: flatten the precedence-sorted intention
    list into a single allow-or-deny policy set.

    The store returns intentions most-precedent-first (exact sources
    before '*', matching evaluate_intentions).  Like the reference we
    keep only the FIRST intention per source (same-source lower
    precedence is shadowed), keep the ones whose action differs from
    the default, and express higher-precedence opposites as not_ids on
    the wildcard principal."""
    seen: set = set()
    effective: list[dict] = []
    for ixn in intentions:
        src = ixn.get("source", "")
        if src in seen:
            continue  # removeSameSourceIntentions
        seen.add(src)
        effective.append(ixn)

    flip = "deny" if default_allow else "allow"
    policies: dict[str, dict] = {}
    shadowing_opposites: list[str] = []
    for ixn in effective:
        action = ixn.get("action", "allow")
        src = ixn.get("source", "")
        if action != flip:
            if src != "*":
                # Same action as default — only relevant as a carve-out
                # under a later wildcard of the opposite action.
                shadowing_opposites.append(src)
            continue
        principal = _spiffe_principal(src, trust_domain)
        if src == "*" and shadowing_opposites:
            # rbac.go removeSourcePrecedence: exact sources that keep
            # the default action are AND-NOT'ed out of the wildcard.
            principal = {
                "and_ids": {"ids": [
                    principal,
                    *[
                        {"not_id": _spiffe_principal(s, trust_domain)}
                        for s in shadowing_opposites
                    ],
                ]}
            }
        policies[f"consul-intentions-layer4-{src}"] = {
            "permissions": [{"any": True}],
            "principals": [principal],
        }

    # default allow → RBAC action DENY listing the denied sources;
    # default deny → RBAC action ALLOW listing the allowed sources.
    return {
        "action": "DENY" if default_allow else "ALLOW",
        "policies": policies,
    }


def rbac_network_filter(snap: dict, trust_domain: str) -> dict:
    """rbac.go makeRBACNetworkFilter."""
    return {
        "name": "envoy.filters.network.rbac",
        "typed_config": {
            "@type": ("type.googleapis.com/envoy.config.filter."
                      "network.rbac.v2.RBAC"),
            "stat_prefix": "connect_authz",
            "rules": rbac_rules_from_intentions(
                snap.get("intentions") or [],
                bool(snap.get("default_allow", True)),
                trust_domain,
            ),
        },
    }


# ---------------------------------------------------------------------------
# clusters (clusters.go)
# ---------------------------------------------------------------------------


def _tls_context(snap: dict, sni: str) -> dict:
    """clusters.go makeUpstreamTLSContext: client cert = this proxy's
    leaf, validation = CA roots, SNI pinned to the target."""
    roots_pem = "".join(
        r.get("root_cert_pem", "") for r in snap.get("roots") or []
    )
    leaf = snap.get("leaf") or {}
    return {
        "common_tls_context": {
            "tls_certificates": [{
                "certificate_chain": {
                    "inline_string": leaf.get("cert_pem", "")},
                "private_key": {
                    "inline_string": leaf.get("private_key_pem", "")},
            }],
            "validation_context": {
                "trusted_ca": {"inline_string": roots_pem},
            },
        },
        "sni": sni,
    }


def clusters_from_snapshot(snap: dict) -> list[dict]:
    """clusters.go clustersFromSnapshotConnectProxy: the local_app
    cluster plus one cluster per chain target of every upstream."""
    trust_domain = trust_domain_from_roots(snap)
    # local_service_address may be "host:port" or bare "host" (the
    # reference keeps LocalServiceAddress and LocalServicePort separate).
    lsa = snap.get("local_service_address", "")
    host, _, port = lsa.rpartition(":")
    if not host or not port.isdigit():
        host, port = lsa, "0"
    clusters: list[dict] = [{
        "@type": CLUSTER_TYPE,
        "name": LOCAL_APP_CLUSTER,
        "type": "STATIC",
        "connect_timeout": "5s",
        "load_assignment": {
            "cluster_name": LOCAL_APP_CLUSTER,
            "endpoints": [{"lb_endpoints": [{
                "endpoint": {"address": {"socket_address": {
                    "address": host or "127.0.0.1",
                    "port_value": int(port or 0),
                }}},
            }]}],
        },
    }]
    for name, up in (snap.get("upstreams") or {}).items():
        chain = up.get("chain") or {}
        targets = chain.get("targets") or {}
        if not targets:
            # No chain compiled — one implicit cluster for the upstream.
            targets = {f"{name}@{snap.get('datacenter', '')}": {
                "service": name, "subset": "",
                "datacenter": snap.get("datacenter", ""), "sni": "",
            }}
        for tid, target in targets.items():
            cname = _target_cluster_name(tid, target, trust_domain)
            connect_timeout = "5s"
            for node in (chain.get("nodes") or {}).values():
                res = node.get("resolver") or {}
                if node.get("type") == "resolver" and \
                        res.get("target") == tid:
                    connect_timeout = (
                        f"{res.get('connect_timeout_s', 5):g}s")
            clusters.append({
                "@type": CLUSTER_TYPE,
                "name": cname,
                "type": "EDS",
                "eds_cluster_config": {
                    "eds_config": {"ads": {}},
                },
                "connect_timeout": connect_timeout,
                "outlier_detection": {},
                "transport_socket": {
                    "name": "tls",
                    "typed_config": {
                        "@type": ("type.googleapis.com/envoy.api.v2."
                                  "auth.UpstreamTlsContext"),
                        **_tls_context(
                            snap, target_sni(target, trust_domain)),
                    },
                },
                # Metadata for consumers that need the raw target.
                "metadata": {"consul": {
                    "target_id": tid,
                    "datacenter": target.get("datacenter", ""),
                    "mesh_gateway": target.get("mesh_gateway", ""),
                }},
            })
    return clusters


# ---------------------------------------------------------------------------
# endpoints (endpoints.go)
# ---------------------------------------------------------------------------


def endpoints_from_snapshot(snap: dict) -> list[dict]:
    """endpoints.go endpointsFromSnapshotConnectProxy: one
    ClusterLoadAssignment per chain target, from the health-watched (or
    gateway-substituted) instances proxycfg resolved."""
    trust_domain = trust_domain_from_roots(snap)
    out = []
    for up in (snap.get("upstreams") or {}).values():
        chain = up.get("chain") or {}
        targets = chain.get("targets") or {}
        for tid, instances in (up.get("instances") or {}).items():
            target = targets.get(tid) or {
                "service": tid.partition("@")[0], "subset": "",
                "datacenter": tid.partition("@")[2], "sni": "",
            }
            out.append({
                "@type": ENDPOINT_TYPE,
                "cluster_name": _target_cluster_name(
                    tid, target, trust_domain),
                "endpoints": [{"lb_endpoints": [
                    {
                        "endpoint": {"address": {"socket_address": {
                            "address": ep.get("address", ""),
                            "port_value": int(ep.get("port", 0)),
                        }}},
                        "health_status": "HEALTHY",
                    }
                    for ep in instances
                ]}],
            })
    return out


# ---------------------------------------------------------------------------
# routes (routes.go)
# ---------------------------------------------------------------------------


def _route_match(definition: dict) -> dict:
    """routes.go makeRouteMatchForDiscoveryRoute."""
    http = (definition.get("match") or {}).get("http") or {}
    match: dict[str, Any] = {}
    if http.get("path_exact"):
        match["path"] = http["path_exact"]
    elif http.get("path_regex"):
        match["safe_regex"] = {"regex": http["path_regex"]}
    else:
        match["prefix"] = http.get("path_prefix", "/")
    headers = []
    for h in http.get("header") or []:
        hm: dict[str, Any] = {"name": h.get("name", "")}
        if h.get("exact"):
            hm["exact_match"] = h["exact"]
        elif h.get("prefix"):
            hm["prefix_match"] = h["prefix"]
        elif h.get("regex"):
            hm["safe_regex_match"] = {"regex": h["regex"]}
        elif h.get("present"):
            hm["present_match"] = True
        if h.get("invert"):
            hm["invert_match"] = True
        headers.append(hm)
    if headers:
        match["headers"] = headers
    return match


def _route_action(chain: dict, next_node: str, trust_domain: str) -> dict:
    """routes.go makeRouteActionForChain: a splitter becomes
    weighted_clusters, a resolver a single cluster."""
    nodes = chain.get("nodes") or {}
    targets = chain.get("targets") or {}
    node = nodes.get(next_node) or {}
    if node.get("type") == "splitter":
        total = sum(float(s.get("weight", 0)) for s in node["splits"])
        wc = []
        for split in node["splits"]:
            child = nodes.get(split["next_node"]) or {}
            tid = (child.get("resolver") or {}).get("target", "")
            target = targets.get(tid) or {}
            wc.append({
                "name": _target_cluster_name(tid, target, trust_domain),
                # Envoy weights are integral per-10000 in the reference.
                "weight": int(round(
                    10000 * float(split.get("weight", 0))
                    / (total or 1))),
            })
        # Envoy validates sum(weights) == total_weight; independent
        # rounding can drift (three equal splits → 3×3333) — land the
        # remainder on the largest cluster.
        drift = 10000 - sum(c["weight"] for c in wc)
        if drift and wc:
            max(wc, key=lambda c: c["weight"])["weight"] += drift
        return {"weighted_clusters": {"clusters": wc,
                                      "total_weight": 10000}}
    tid = (node.get("resolver") or {}).get("target", "")
    target = targets.get(tid) or {}
    return {"cluster": _target_cluster_name(tid, target, trust_domain)}


def routes_from_snapshot(snap: dict) -> list[dict]:
    """routes.go routesFromSnapshot: RouteConfiguration per upstream
    whose chain speaks http."""
    trust_domain = trust_domain_from_roots(snap)
    out = []
    for name, up in (snap.get("upstreams") or {}).items():
        chain = up.get("chain") or {}
        if chain.get("protocol", "tcp") not in ("http", "http2", "grpc"):
            continue
        nodes = chain.get("nodes") or {}
        start = nodes.get(chain.get("start_node", "")) or {}
        routes = []
        if start.get("type") == "router":
            for route in start.get("routes") or []:
                routes.append({
                    "match": _route_match(route.get("definition") or {}),
                    "route": _route_action(
                        chain, route["next_node"], trust_domain),
                })
        else:
            routes.append({
                "match": {"prefix": "/"},
                "route": _route_action(
                    chain, chain.get("start_node", ""), trust_domain),
            })
        out.append({
            "@type": ROUTE_TYPE,
            "name": name,
            "virtual_hosts": [{
                "name": name,
                "domains": ["*"],
                "routes": routes,
            }],
        })
    return out


# ---------------------------------------------------------------------------
# listeners (listeners.go)
# ---------------------------------------------------------------------------


def _socket_address(addr: str, port: int) -> dict:
    return {"socket_address": {"address": addr, "port_value": int(port)}}


def listeners_from_snapshot(snap: dict,
                            public_port: int = 0) -> list[dict]:
    """listeners.go listenersFromSnapshotConnectProxy: the public mTLS
    listener + one outbound listener per upstream bind address."""
    trust_domain = trust_domain_from_roots(snap)
    roots_pem = "".join(
        r.get("root_cert_pem", "") for r in snap.get("roots") or []
    )
    leaf = snap.get("leaf") or {}
    listeners = [{
        "@type": LISTENER_TYPE,
        "name": f"{PUBLIC_LISTENER}:0.0.0.0:{public_port}",
        "address": _socket_address("0.0.0.0", public_port),
        "filter_chains": [{
            "tls_context": {
                "common_tls_context": {
                    "tls_certificates": [{
                        "certificate_chain": {
                            "inline_string": leaf.get("cert_pem", "")},
                        "private_key": {"inline_string":
                                        leaf.get("private_key_pem", "")},
                    }],
                    "validation_context": {
                        "trusted_ca": {"inline_string": roots_pem}},
                },
                "require_client_certificate": True,
            },
            "filters": [
                rbac_network_filter(snap, trust_domain),
                {
                    "name": "envoy.tcp_proxy",
                    "typed_config": {
                        "@type": ("type.googleapis.com/envoy.config."
                                  "filter.network.tcp_proxy.v2.TcpProxy"),
                        "stat_prefix": "public_listener",
                        "cluster": LOCAL_APP_CLUSTER,
                    },
                },
            ],
        }],
        "traffic_direction": "INBOUND",
    }]
    for name, up in (snap.get("upstreams") or {}).items():
        chain = up.get("chain") or {}
        bind_addr = up.get("local_bind_address", "127.0.0.1")
        bind_port = int(up.get("local_bind_port", 0))
        protocol = chain.get("protocol", "tcp")
        if protocol in ("http", "http2", "grpc"):
            filters = [{
                "name": "envoy.http_connection_manager",
                "typed_config": {
                    "@type": ("type.googleapis.com/envoy.config.filter."
                              "network.http_connection_manager.v2."
                              "HttpConnectionManager"),
                    "stat_prefix": f"upstream.{name}",
                    "rds": {
                        "route_config_name": name,
                        "config_source": {"ads": {}},
                    },
                    "http_filters": [{"name": "envoy.router"}],
                },
            }]
        else:
            # L4: point at the chain's primary target cluster.
            start = (chain.get("nodes") or {}).get(
                chain.get("start_node", "")) or {}
            tid = (start.get("resolver") or {}).get("target", "")
            target = (chain.get("targets") or {}).get(tid)
            if target is None:
                cluster = _target_cluster_name("", {
                    "service": name, "subset": "",
                    "datacenter": snap.get("datacenter", ""), "sni": "",
                }, trust_domain)
            else:
                cluster = _target_cluster_name(tid, target, trust_domain)
            filters = [{
                "name": "envoy.tcp_proxy",
                "typed_config": {
                    "@type": ("type.googleapis.com/envoy.config.filter."
                              "network.tcp_proxy.v2.TcpProxy"),
                    "stat_prefix": f"upstream.{name}",
                    "cluster": cluster,
                },
            }]
        listeners.append({
            "@type": LISTENER_TYPE,
            "name": f"{name}:{bind_addr}:{bind_port}",
            "address": _socket_address(bind_addr, bind_port),
            "filter_chains": [{"filters": filters}],
            "traffic_direction": "OUTBOUND",
        })
    return listeners


# ---------------------------------------------------------------------------
# ADS snapshot (server.go StreamAggregatedResources, one-shot form)
# ---------------------------------------------------------------------------


def ads_snapshot(snap: dict, version: int,
                 public_port: int = 0) -> dict:
    """The four resource families in one versioned response — the
    aggregated-discovery shape (server.go:475 streams these as separate
    typed DiscoveryResponses; consumers here get them keyed by type
    URL)."""
    return {
        "version_info": str(version),
        "resources": {
            CLUSTER_TYPE: clusters_from_snapshot(snap),
            ENDPOINT_TYPE: endpoints_from_snapshot(snap),
            LISTENER_TYPE: listeners_from_snapshot(snap, public_port),
            ROUTE_TYPE: routes_from_snapshot(snap),
        },
    }
