"""Immutable (path-copying) radix tree with per-node watch events; the
port's copy of ``consul_tpu/store/iradix.py``.

The storage kernel of the consistency plane — the equivalent of the
reference's vendored ``go-immutable-radix``, which backs ``go-memdb``
(``state/state_store.go:102``).  Three properties matter and are kept:

  1. **Snapshot isolation**: a committed ``Tree`` is immutable; writers
     build a new tree by path-copying inside a ``Txn`` and publish it
     atomically, so readers holding an old root see a frozen view.
  2. **Per-node watches**: every node lazily owns an ``asyncio.Event``.
     A transaction records the event of every node it copies or drops,
     and ``commit()`` fires them.  Because an insert/delete path-copies
     all ancestors, watching the node that covers a prefix wakes on any
     change beneath it — this is exactly the radix-watch mechanism that
     powers the reference's blocking queries (``rpc.go:759``,
     ``state/memdb.go``).  Spurious wakeups are allowed (callers
     re-check indexes), missed wakeups are not.
  3. **Ordered iteration**: edges are sorted by label byte so prefix
     scans yield keys in lexicographic order (memdb iterator order).

Pure Python, as in the JAX package, whose ``bench_kv.py`` measured its
KV plane above the reference's published numbers (bench/results-0.7.1.md:
3,780 PUT/s, 9,774 stale GET/s).  The port's KV plane is not measured
yet: its ``bench_kv.py`` comes with the agent commands.
"""

from __future__ import annotations

import asyncio
from bisect import bisect_left
from typing import Any, Iterator, Optional


class Node:
    __slots__ = ("prefix", "key", "value", "has_leaf", "edges", "_watch")

    def __init__(self, prefix: bytes = b""):
        self.prefix = prefix
        self.key: Optional[bytes] = None
        self.value: Any = None
        self.has_leaf = False
        self.edges: list[tuple[int, "Node"]] = []
        self._watch: Optional[asyncio.Event] = None

    # -- watches ----------------------------------------------------------
    def watch(self) -> asyncio.Event:
        if self._watch is None:
            self._watch = asyncio.Event()
        return self._watch

    # -- edges ------------------------------------------------------------
    def _edge_idx(self, label: int) -> int:
        return bisect_left(self.edges, label, key=lambda e: e[0])

    def get_edge(self, label: int) -> Optional["Node"]:
        i = self._edge_idx(label)
        if i < len(self.edges) and self.edges[i][0] == label:
            return self.edges[i][1]
        return None

    def set_edge(self, label: int, child: "Node") -> None:
        i = self._edge_idx(label)
        if i < len(self.edges) and self.edges[i][0] == label:
            self.edges[i] = (label, child)
        else:
            self.edges.insert(i, (label, child))

    def del_edge(self, label: int) -> None:
        i = self._edge_idx(label)
        if i < len(self.edges) and self.edges[i][0] == label:
            del self.edges[i]


def _common_prefix_len(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class Tree:
    """An immutable committed radix tree. Mutate via ``txn()``."""

    __slots__ = ("root", "size")

    def __init__(self, root: Optional[Node] = None, size: int = 0):
        self.root = root if root is not None else Node()
        self.size = size

    def txn(self) -> "Txn":
        return Txn(self)

    # -- reads ------------------------------------------------------------
    def get(self, key: bytes) -> tuple[Any, bool]:
        _, value, found = self.get_watch(key)
        return value, found

    def get_watch(self, key: bytes) -> tuple[asyncio.Event, Any, bool]:
        """Value lookup returning the watch event that will fire when
        this key is created/modified/deleted (go-iradix ``GetWatch``)."""
        node = self.root
        search = key
        while True:
            if not search:
                if node.has_leaf:
                    return node.watch(), node.value, True
                return node.watch(), None, False
            child = node.get_edge(search[0])
            if child is None:
                return node.watch(), None, False
            if search[: len(child.prefix)] == child.prefix:
                node = child
                search = search[len(child.prefix):]
            else:
                # Diverges inside the child's prefix: an insert of this
                # key would split (and thus copy) that child.
                return child.watch(), None, False

    def watch_prefix(self, prefix: bytes) -> asyncio.Event:
        """Watch event firing when anything at/below ``prefix`` changes
        (memdb iterator ``WatchCh`` semantics)."""
        node = self.root
        search = prefix
        while search:
            child = node.get_edge(search[0])
            if child is None:
                return node.watch()
            cp = _common_prefix_len(search, child.prefix)
            if cp == len(search) or cp == len(child.prefix):
                node = child
                search = search[cp:]
            else:
                return child.watch()
        return node.watch()

    def iterate(self, prefix: bytes = b"") -> Iterator[tuple[bytes, Any]]:
        """Lexicographic (key, value) iteration over keys with prefix."""
        node = self.root
        search = prefix
        while search:
            child = node.get_edge(search[0])
            if child is None:
                return
            cp = _common_prefix_len(search, child.prefix)
            if cp == len(search):
                node = child  # prefix ends inside/at this child
                break
            if cp < len(child.prefix):
                return
            node = child
            search = search[cp:]
        yield from self._iter_node(node)

    @staticmethod
    def _iter_node(node: Node) -> Iterator[tuple[bytes, Any]]:
        stack = [node]
        while stack:
            n = stack.pop()
            if n.has_leaf:
                yield n.key, n.value
            # push reversed so smallest label pops first... but leaf of a
            # child sorts after this node's leaf already; DFS preorder with
            # sorted edges gives lexicographic order.
            for label, child in reversed(n.edges):
                stack.append(child)

    def keys(self, prefix: bytes = b"") -> list[bytes]:
        return [k for k, _ in self.iterate(prefix)]

    def __len__(self) -> int:
        return self.size


class Txn:
    """A write transaction over a Tree; path-copies on mutation and
    fires the watch events of every displaced node on commit."""

    def __init__(self, tree: Tree):
        self._root = tree.root
        self._size = tree.size
        self._fire: set[asyncio.Event] = set()
        # Nodes created inside this txn are mutated in place instead of
        # re-copied on every op (go-iradix writable-node tracking) —
        # keeps multi-op txns at one copy per node, not one per op.
        self._writable: set[int] = set()

    # -- internals --------------------------------------------------------
    def _track(self, node: Node) -> None:
        if node._watch is not None:
            self._fire.add(node._watch)

    def _new_node(self, prefix: bytes) -> Node:
        node = Node(prefix)
        self._writable.add(id(node))
        return node

    def _copy(self, node: Node) -> Node:
        if id(node) in self._writable:
            return node
        self._track(node)
        new = Node(node.prefix)
        new.key = node.key
        new.value = node.value
        new.has_leaf = node.has_leaf
        new.edges = list(node.edges)
        self._writable.add(id(new))
        return new

    # -- mutations --------------------------------------------------------
    def insert(self, key: bytes, value: Any) -> tuple[Any, bool]:
        """Returns (old_value, did_update)."""
        new_root, old, existed = self._insert(self._root, key, key, value)
        self._root = new_root
        if not existed:
            self._size += 1
        return old, existed

    def _insert(
        self, node: Node, key: bytes, search: bytes, value: Any
    ) -> tuple[Node, Any, bool]:
        if not search:
            new = self._copy(node)
            old, existed = (node.value, True) if node.has_leaf else (None, False)
            new.key = key
            new.value = value
            new.has_leaf = True
            return new, old, existed

        child = node.get_edge(search[0])
        if child is None:
            leaf = self._new_node(search)
            leaf.key = key
            leaf.value = value
            leaf.has_leaf = True
            new = self._copy(node)
            new.set_edge(search[0], leaf)
            return new, None, False

        cp = _common_prefix_len(search, child.prefix)
        if cp == len(child.prefix):
            new_child, old, existed = self._insert(child, key, search[cp:], value)
            new = self._copy(node)
            new.set_edge(search[0], new_child)
            return new, old, existed

        # Split the child at the divergence point.
        self._track(child)
        split = self._new_node(search[:cp])
        mod_child = self._copy(child)
        mod_child.prefix = child.prefix[cp:]
        split.set_edge(mod_child.prefix[0], mod_child)
        rest = search[cp:]
        if rest:
            leaf = self._new_node(rest)
            leaf.key = key
            leaf.value = value
            leaf.has_leaf = True
            split.set_edge(rest[0], leaf)
        else:
            split.key = key
            split.value = value
            split.has_leaf = True
        new = self._copy(node)
        new.set_edge(search[0], split)
        return new, None, False

    def delete(self, key: bytes) -> tuple[Any, bool]:
        """Returns (old_value, deleted)."""
        result = self._delete(self._root, key, is_root=True)
        if result is None:
            return None, False
        new_root, old = result
        self._root = new_root if new_root is not None else Node()
        self._size -= 1
        return old, True

    def _delete(
        self, node: Node, search: bytes, is_root: bool = False
    ) -> Optional[tuple[Optional[Node], Any]]:
        if not search:
            if not node.has_leaf:
                return None
            old = node.value
            new = self._copy(node)
            new.key = None
            new.value = None
            new.has_leaf = False
            if not is_root and not new.edges:
                return None, old  # node vanishes entirely
            if not is_root and len(new.edges) == 1:
                self._merge_child(new)
            return new, old

        child = node.get_edge(search[0])
        if child is None or search[: len(child.prefix)] != child.prefix:
            return None
        result = self._delete(child, search[len(child.prefix):])
        if result is None:
            return None
        new_child, old = result
        new = self._copy(node)
        if new_child is None:
            new.del_edge(search[0])
            if not is_root and not new.has_leaf and len(new.edges) == 1:
                self._merge_child(new)
            if not is_root and not new.has_leaf and not new.edges:
                return None, old
        else:
            new.set_edge(search[0], new_child)
        return new, old

    def delete_prefix(self, prefix: bytes) -> int:
        """Drop the whole subtree under ``prefix``; returns count removed."""
        doomed = [k for k, _ in Tree(self._root, self._size).iterate(prefix)]
        for k in doomed:
            self.delete(k)
        return len(doomed)

    def _merge_child(self, node: Node) -> None:
        label, child = node.edges[0]
        self._track(child)
        node.prefix = node.prefix + child.prefix
        node.key = child.key
        node.value = child.value
        node.has_leaf = child.has_leaf
        node.edges = list(child.edges)

    # -- reads within txn -------------------------------------------------
    def get(self, key: bytes) -> tuple[Any, bool]:
        return Tree(self._root, self._size).get(key)

    def commit(self) -> Tree:
        tree = Tree(self._root, self._size)
        for event in self._fire:
            event.set()
        self._fire = set()
        self._writable = set()  # committed nodes are frozen from here on
        return tree
