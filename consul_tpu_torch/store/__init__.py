"""Storage kernel: immutable-radix memdb + the domain state store; the
port's copy of ``consul_tpu.store``.

``iradix``  — path-copying radix tree with per-node watch events
              (go-immutable-radix equivalent).
``memdb``   — tables/indexes/transactions + WatchSet + change capture
              (go-memdb equivalent, ``state/memdb.go``).
``state``   — the replicated StateStore (catalog, KV, sessions,
              coordinates, config entries, prepared queries, ACLs).
"""

from consul_tpu_torch.store.iradix import Tree
from consul_tpu_torch.store.memdb import (
    Change,
    IndexSchema,
    MemDB,
    MemTxn,
    TableSchema,
    WatchSet,
)
from consul_tpu_torch.store.state import (
    HEALTH_CRITICAL,
    HEALTH_PASSING,
    HEALTH_WARNING,
    SESSION_BEHAVIOR_DELETE,
    SESSION_BEHAVIOR_RELEASE,
    StateStore,
)

__all__ = [
    "Tree",
    "Change",
    "IndexSchema",
    "MemDB",
    "MemTxn",
    "TableSchema",
    "WatchSet",
    "StateStore",
    "HEALTH_PASSING",
    "HEALTH_WARNING",
    "HEALTH_CRITICAL",
    "SESSION_BEHAVIOR_RELEASE",
    "SESSION_BEHAVIOR_DELETE",
]
