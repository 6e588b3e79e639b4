"""Connect, the service mesh; the port's copy of ``consul_tpu.connect``,
so far its mesh-gateway locator for WAN federation, which every
``Server`` builds.

The built-in CA, the SPIFFE identities, the discovery-chain compiler and
the proxy plane come with the rest of Connect.
"""

from consul_tpu_torch.connect.gateways import GatewayLocator

__all__ = ["GatewayLocator"]
