"""Client library for the HTTP API; the port's copy of
``consul_tpu/api/__init__.py``.

Equivalent of the reference's ``api/`` Go package (SURVEY.md §2.3): a
typed client over the agent's HTTP endpoints plus watch plans
(``api/watch``).  Used by the CLI the same way ``command/`` sits on
``api/`` in the reference.
"""

from consul_tpu_torch.api.client import ConsulClient, QueryMeta
from consul_tpu_torch.api.watch import WatchPlan, parse_watch

__all__ = ["ConsulClient", "QueryMeta", "WatchPlan", "parse_watch"]
