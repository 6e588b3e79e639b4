"""Mesh-gateway locator for WAN federation; the port's copy of
``consul_tpu/connect/gateways.py``.

Parity model: ``agent/consul/gateway_locator.go`` — when WAN federation
via mesh gateways is enabled, a server reaches a remote datacenter by
dialing a LOCAL mesh gateway, which tunnels to a REMOTE mesh gateway in
the destination DC.  The locator answers "which gateways?" from two
sources:

  local gateways     the local catalog's ``kind == "mesh-gateway"``
                     service instances (LAN addresses)
  remote gateways    the replicated ``federation_states`` table — each
                     DC's leader publishes its own gateway set to the
                     primary (anti-entropy), and secondaries pull the
                     full map back (federation_state_replication.go)

The reference restricts wan-federation routing to gateways carrying the
``consul-wan-federation=1`` service meta (gateway_locator.go:44-47
"ONLY contain ones that have the wanfed:1 meta"); we keep the same
gate.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from consul_tpu_torch.store.state import StateStore

WANFED_META = "consul-wan-federation"
KIND_MESH_GATEWAY = "mesh-gateway"


def gateway_endpoint(svc: dict, wan: bool) -> dict:
    """Advertised (address, port) for a gateway instance as a data-plane
    endpoint dict.  WAN side prefers tagged_addresses["wan"]
    (structs.ServiceGatewayVirtualIPTag conventions); LAN side the
    service address, falling back to the node address."""
    tagged = svc.get("tagged_addresses") or {}
    addr, port = "", svc.get("port", 0)
    if wan and tagged.get("wan"):
        t = tagged["wan"]
        if isinstance(t, dict):
            addr, port = t.get("address", ""), t.get("port", port)
        else:
            addr = str(t)
    if not addr:
        addr = svc.get("address") or svc.get("node_address") or ""
    return {
        "address": addr, "port": port,
        "proxy_id": svc.get("id", ""),
        "node": svc.get("node", ""),
        "mesh_gateway": True,
    }


def _gateway_addr(svc: dict, wan: bool) -> str:
    ep = gateway_endpoint(svc, wan)
    return f"{ep['address']}:{ep['port']}"


class GatewayLocator:
    """gateway_locator.go GatewayLocator (pull-based redesign: the
    reference maintains push-updated sorted slices under locks; here
    every read recomputes from the single-writer state store, which is
    already index-watched and cheap at catalog scale)."""

    def __init__(self, store: "StateStore", datacenter: str,
                 primary_datacenter: str):
        self.store = store
        self.datacenter = datacenter
        self.primary_datacenter = primary_datacenter or datacenter

    # -- catalog side ---------------------------------------------------

    def local_gateway_services(self, wanfed_only: bool = False) -> list[dict]:
        _, svcs = self.store.services_by_kind(KIND_MESH_GATEWAY)
        if wanfed_only:
            svcs = [s for s in svcs
                    if (s.get("meta") or {}).get(WANFED_META) == "1"]
        return svcs

    def local_gateways(self) -> list[str]:
        """LAN addresses of this DC's wanfed mesh gateways
        (gateway_locator.go listGateways(false))."""
        return sorted({
            _gateway_addr(s, wan=False)
            for s in self.local_gateway_services(wanfed_only=True)
        })

    # -- federation-state side ------------------------------------------

    def gateways_for_dc(self, dc: str) -> list[str]:
        """WAN addresses of a remote DC's mesh gateways, as published
        in its federation state."""
        if dc == self.datacenter:
            return self.local_gateways()
        _, state = self.store.federation_state_get(dc)
        if not state:
            return []
        return sorted({
            _gateway_addr(s, wan=True)
            for s in state.get("mesh_gateways", [])
        })

    def primary_gateways(self) -> list[str]:
        """gateway_locator.go PrimaryGatewayFallbackAddresses — the
        primary's published gateways, the bootstrap path for a
        secondary."""
        return self.gateways_for_dc(self.primary_datacenter)

    def known_datacenters(self) -> list[str]:
        _, states = self.store.federation_state_list()
        return sorted(s["datacenter"] for s in states)

    def build_own_state(self) -> Optional[dict]:
        """This DC's federation state, from the local catalog
        (leader_federation_state_ae.go FederationStateAntiEntropy
        assembles the same shape before pushing to the primary)."""
        gateways = self.local_gateway_services(wanfed_only=True)
        return {
            "datacenter": self.datacenter,
            "mesh_gateways": [
                {k: v for k, v in s.items()
                 if k not in ("create_index", "modify_index")}
                for s in gateways
            ],
        }
