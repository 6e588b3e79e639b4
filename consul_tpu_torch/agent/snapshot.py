"""User-facing snapshot save/restore: atomic state archives; the port's
copy of ``consul_tpu/agent/snapshot.py``, whose archives it writes byte
for byte and reads (the state goes through ``net/wire.py``, not the
``msgpack`` package).

Equivalent of ``snapshot/snapshot.go`` + ``archive.go`` (SURVEY.md
§2.3): a snapshot is a gzipped tar containing

    meta.json    raft index/term + the saving node (archive.go writeMeta)
    state.bin    msgpack of the FSM snapshot (the whole state store)
    SHA256SUMS   manifest over the other two files, verified byte-for-
                 byte on restore (archive.go checksums — a corrupted or
                 tampered archive is rejected before any state changes)

Restore is leader-driven and replicated: the unpacked state rides ONE
raft entry (the Restore message), so every replica installs the same
snapshot at the same log position — the in-process counterpart of the
reference's raft.Restore + InstallSnapshot propagation
(consul/snapshot_endpoint.go).
"""

from __future__ import annotations

import gzip
import hashlib
import io
import json
import tarfile
import zlib
from typing import Any

from consul_tpu_torch.net import wire


class SnapshotError(Exception):
    """Bad archive: corrupt, tampered, or incomplete."""


def _tar_add(tar: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    info.mtime = 0  # deterministic archives
    tar.addfile(info, io.BytesIO(data))


def write_archive(state: Any, index: int, term: int, node: str) -> bytes:
    """Pack an FSM snapshot into the tar.gz + SHA256SUMS format."""
    state_bin = wire.packb(state)
    meta = json.dumps(
        {"index": index, "term": term, "node": node, "version": 1}
    ).encode()
    sums = "".join(
        f"{hashlib.sha256(data).hexdigest()}  {name}\n"
        for name, data in (("meta.json", meta), ("state.bin", state_bin))
    ).encode()
    buf = io.BytesIO()
    # mtime=0: archives for identical state are byte-identical.
    with gzip.GzipFile(fileobj=buf, mode="wb", mtime=0) as gz:
        with tarfile.open(fileobj=gz, mode="w") as tar:
            _tar_add(tar, "meta.json", meta)
            _tar_add(tar, "state.bin", state_bin)
            _tar_add(tar, "SHA256SUMS", sums)
    return buf.getvalue()


def read_archive(blob: bytes) -> tuple[Any, dict]:
    """Unpack + verify; returns (state, meta).  Raises SnapshotError on
    any integrity failure (archive.go read + checksum verify).

    Stricter than the JAX package's copy, which reads the tar straight
    from the gzip stream: the tar reader stops at the end-of-archive
    blocks, so the gzip CRC-32 and length are never checked and a change
    there (or a cut of the last bytes) reads as a good archive, and a
    SHA256SUMS that no longer decodes raises UnicodeDecodeError.  Here the
    whole stream is inflated first, so both are a SnapshotError; only the
    gzip header's MTIME, XFL, OS and FTEXT, which carry no data, may
    change unnoticed.  Good archives read the same in both packages."""
    try:
        with gzip.GzipFile(fileobj=io.BytesIO(blob)) as gz:
            raw = gz.read()
        with tarfile.open(fileobj=io.BytesIO(raw), mode="r") as tar:
            files = {}
            for member in tar.getmembers():
                fh = tar.extractfile(member)
                if fh is not None:
                    files[member.name] = fh.read()
    except (OSError, tarfile.TarError, EOFError, zlib.error) as e:
        raise SnapshotError(f"unreadable archive: {e}") from e
    for required in ("meta.json", "state.bin", "SHA256SUMS"):
        if required not in files:
            raise SnapshotError(f"archive missing {required}")
    try:
        sums = files["SHA256SUMS"].decode()
    except UnicodeDecodeError as e:
        raise SnapshotError(f"unreadable SHA256SUMS: {e}") from e
    expected: dict[str, str] = {}
    for line in sums.splitlines():
        digest, _, name = line.partition("  ")
        if name:
            expected[name] = digest
    for name in ("meta.json", "state.bin"):
        actual = hashlib.sha256(files[name]).hexdigest()
        if expected.get(name) != actual:
            raise SnapshotError(f"checksum mismatch for {name}")
    try:
        meta = json.loads(files["meta.json"])
        state = wire.unpackb(files["state.bin"], strict_map_key=False)
    except ValueError as e:
        raise SnapshotError(f"undecodable archive content: {e}") from e
    return state, meta
