"""In-memory transactional multi-index database over immutable radix trees;
the port's copy of ``consul_tpu/store/memdb.py``.

The ``go-memdb`` equivalent (the reference's state store substrate,
``state/state_store.go:102``, ``state/memdb.go:35-80``):

  - a database is a set of **tables**; each table has a unique ``id``
    index plus any number of secondary indexes, every index its own
    radix tree;
  - a **write txn** stages path-copied trees and publishes them
    atomically on commit, firing radix watches; readers use the last
    committed root (snapshot isolation);
  - commits also emit a **change list** (table, op, old, new) — the
    hook the reference uses to feed its event publisher
    (``state/memdb.go:37-41`` changeTrackerDB).

Records are plain dicts (msgpack/JSON-friendly).  Secondary index keys
are made unique by appending the record's primary key.
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Any, Callable, Iterator, Optional

from consul_tpu_torch.store.iradix import Tree

SEP = b"\x00"


@dataclasses.dataclass(frozen=True)
class IndexSchema:
    name: str
    key: Callable[[dict], Optional[bytes]]  # None => record absent from index
    unique: bool = False


@dataclasses.dataclass(frozen=True)
class TableSchema:
    name: str
    primary: Callable[[dict], bytes]
    indexes: tuple[IndexSchema, ...] = ()


@dataclasses.dataclass(frozen=True)
class Change:
    table: str
    op: str  # "insert" | "update" | "delete"
    before: Optional[dict]
    after: Optional[dict]


class WatchSet:
    """A set of radix watch events; wait() resolves when any fires
    (memdb ``WatchSet``, consumed by blockingQuery ``rpc.go:804``)."""

    def __init__(self) -> None:
        self._events: set[asyncio.Event] = set()

    def add(self, event: Optional[asyncio.Event]) -> None:
        if event is not None:
            self._events.add(event)

    def __len__(self) -> int:
        return len(self._events)

    async def wait(self, timeout: Optional[float] = None) -> bool:
        """True if a watch fired, False on timeout."""
        if not self._events:
            if timeout:
                await asyncio.sleep(timeout)
            return False
        tasks = [asyncio.create_task(e.wait()) for e in self._events]
        try:
            done, _ = await asyncio.wait(
                tasks, timeout=timeout, return_when=asyncio.FIRST_COMPLETED
            )
            return bool(done)
        finally:
            for t in tasks:
                t.cancel()


class MemDB:
    def __init__(self, schemas: list[TableSchema]):
        self.schemas: dict[str, TableSchema] = {s.name: s for s in schemas}
        # (table, index) -> committed Tree; index "" is the primary.
        self._trees: dict[tuple[str, str], Tree] = {}
        self._write_active = False  # single-writer (go-memdb writer lock)
        self._active_write: Optional["MemTxn"] = None
        for s in schemas:
            self._trees[(s.name, "id")] = Tree()
            for idx in s.indexes:
                self._trees[(s.name, idx.name)] = Tree()

    def txn(self, write: bool = False) -> "MemTxn":
        if write:
            if self._write_active:
                raise RuntimeError(
                    "concurrent write transaction (memdb is single-writer)"
                )
            self._write_active = True
            txn = MemTxn(self, True)
            self._active_write = txn
            return txn
        return MemTxn(self, write)

    def abort_active(self) -> None:
        """Abort a write txn abandoned by an exception so the writer
        lock is never wedged (used by StateStore's write-method guard)."""
        if self._active_write is not None and not self._active_write._done:
            self._active_write.abort()
        self._active_write = None

    def tree(self, table: str, index: str = "id") -> Tree:
        return self._trees[(table, index)]


class MemTxn:
    """Read or read-write transaction. Writes stage new trees; commit
    publishes them and fires watches. Reads inside the txn see staged
    state; outside readers see the old roots until commit."""

    def __init__(self, db: MemDB, write: bool):
        self._db = db
        self._write = write
        # Pin the committed roots at txn start: reads within this txn see
        # one frozen view even if other (sync) commits land while an
        # async caller holds the txn across awaits.
        self._roots = dict(db._trees)
        self._staged: dict[tuple[str, str], Any] = {}  # -> iradix.Txn
        self.changes: list[Change] = []
        self._done = False

    # -- helpers -----------------------------------------------------------
    def _tree(self, table: str, index: str = "id") -> Tree:
        key = (table, index)
        if key in self._staged:
            txn = self._staged[key]
            return Tree(txn._root, txn._size)
        return self._roots[key]

    def _radix_txn(self, table: str, index: str = "id"):
        assert self._write, "read-only txn"
        key = (table, index)
        if key not in self._staged:
            self._staged[key] = self._roots[key].txn()
        return self._staged[key]

    @staticmethod
    def _sec_key(idx: IndexSchema, rec: dict, pk: bytes) -> Optional[bytes]:
        k = idx.key(rec)
        if k is None:
            return None
        return k if idx.unique else k + SEP + pk

    # -- writes ------------------------------------------------------------
    def insert(self, table: str, rec: dict) -> None:
        schema = self._db.schemas[table]
        pk = schema.primary(rec)
        # Unique-index violations must fail up front (go-memdb errors on
        # them; silently overwriting would corrupt the index on delete).
        for idx in schema.indexes:
            if not idx.unique:
                continue
            new_k = self._sec_key(idx, rec, pk)
            if new_k is None:
                continue
            holder = self._tree(table, idx.name).get(new_k)[0]
            if holder is not None and schema.primary(holder) != pk:
                raise ValueError(
                    f"unique index {table}.{idx.name} violation on {new_k!r}"
                )
        old, existed = self._radix_txn(table).insert(pk, rec)
        for idx in schema.indexes:
            rtxn = self._radix_txn(table, idx.name)
            if existed:
                old_k = self._sec_key(idx, old, pk)
                if old_k is not None:
                    rtxn.delete(old_k)
            new_k = self._sec_key(idx, rec, pk)
            if new_k is not None:
                rtxn.insert(new_k, rec)
        self.changes.append(
            Change(table, "update" if existed else "insert", old, rec)
        )

    def delete(self, table: str, pk: bytes) -> Optional[dict]:
        schema = self._db.schemas[table]
        old, deleted = self._radix_txn(table).delete(pk)
        if not deleted:
            return None
        for idx in schema.indexes:
            old_k = self._sec_key(idx, old, pk)
            if old_k is not None:
                self._radix_txn(table, idx.name).delete(old_k)
        self.changes.append(Change(table, "delete", old, None))
        return old

    def delete_prefix(self, table: str, prefix: bytes) -> int:
        doomed = [rec for _, rec in self._tree(table).iterate(prefix)]
        for rec in doomed:
            self.delete(table, self._db.schemas[table].primary(rec))
        return len(doomed)

    # -- reads -------------------------------------------------------------
    def get(
        self, table: str, pk: bytes, ws: Optional[WatchSet] = None
    ) -> Optional[dict]:
        event, value, found = self._tree(table).get_watch(pk)
        if ws is not None:
            ws.add(event)
        return value if found else None

    def iterate(
        self,
        table: str,
        prefix: bytes = b"",
        index: str = "id",
        ws: Optional[WatchSet] = None,
    ) -> Iterator[tuple[bytes, dict]]:
        tree = self._tree(table, index)
        if ws is not None:
            ws.add(tree.watch_prefix(prefix))
        return tree.iterate(prefix)

    def records(
        self,
        table: str,
        prefix: bytes = b"",
        index: str = "id",
        ws: Optional[WatchSet] = None,
    ) -> list[dict]:
        return [rec for _, rec in self.iterate(table, prefix, index, ws)]

    def first(
        self,
        table: str,
        prefix: bytes,
        index: str = "id",
        ws: Optional[WatchSet] = None,
    ) -> Optional[dict]:
        for _, rec in self.iterate(table, prefix, index, ws):
            return rec
        return None

    # -- lifecycle ---------------------------------------------------------
    def commit(self) -> list[Change]:
        assert not self._done
        self._done = True
        for (table, index), rtxn in self._staged.items():
            self._db._trees[(table, index)] = rtxn.commit()
        if self._write:
            self._db._write_active = False
        return self.changes

    def abort(self) -> None:
        self._done = True
        self._staged = {}
        self.changes = []
        if self._write:
            self._db._write_active = False
