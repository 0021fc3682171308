"""Append-only write-ahead log: CRC32-per-record segments, one log per
shard (DESIGN.md section 14).

Record layout (little-endian, `_HEADER` then payload):

    magic  u32   0x57414C31 ("WAL1")
    crc    u32   crc32 over header[8:] + payload (everything below)
    lsn    u64   per-shard log sequence number, dense and monotone
    epoch  u64   engine epoch at append time (diagnostic tag)
    op     u8    1 = upsert, 2 = delete   (+3 pad bytes)
    count  u32   number of keys
    keys   f64[count]
    vals   i64[count]      (upsert only)

One facade write batch = one record = one group commit: the python buffer
is flushed to the OS per append (an in-process crash never loses an acked
record) and fsync'd per the `DurabilityConfig.fsync` policy.

Segments are named `seg_<start_lsn:016d>.wal`; a segment's lsn range is
[its start, the next segment's start), so truncation (`purge_upto`) never
has to read a file: a closed segment is deletable exactly when the NEXT
segment's start lsn is at or below the checkpoint watermark.  The active
segment is never deleted.

Replay (`read_records`) walks segments in lsn order and applies the
torn-tail rule: the first bad magic/CRC/short-read OR lsn discontinuity
ends the log — everything before it is the durable prefix, everything
after is garbage from a crashed writer and is ignored.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from . import hooks

MAGIC = 0x57414C31
OP_UPSERT, OP_DELETE = 1, 2

_HEADER = struct.Struct("<IIQQBxxxI")


def shard_dir(wal_dir: str, shard: int) -> str:
    return os.path.join(wal_dir, f"shard_{shard:05d}")


def _seg_name(start_lsn: int) -> str:
    return f"seg_{start_lsn:016d}.wal"


def _seg_start(name: str) -> int:
    return int(name[4:-4])


def list_segments(d: str) -> list[tuple[int, str]]:
    """(start_lsn, path) of every segment in `d`, lsn-ascending."""
    if not os.path.isdir(d):
        return []
    return sorted((_seg_start(n), os.path.join(d, n))
                  for n in os.listdir(d)
                  if n.startswith("seg_") and n.endswith(".wal"))


def encode_record(lsn: int, epoch: int, op: int, keys: np.ndarray,
                  vals: np.ndarray | None) -> bytes:
    keys = np.ascontiguousarray(keys, np.float64)
    payload = keys.tobytes()
    if op == OP_UPSERT:
        payload += np.ascontiguousarray(vals, np.int64).tobytes()
    meta = _HEADER.pack(MAGIC, 0, lsn, epoch, op, len(keys))
    crc = zlib.crc32(meta[8:] + payload) & 0xFFFFFFFF
    return _HEADER.pack(MAGIC, crc, lsn, epoch, op, len(keys)) + payload


def _decode_one(buf: bytes, off: int):
    """(record dict, next offset) or None at the first torn/corrupt byte."""
    if off + _HEADER.size > len(buf):
        return None
    magic, crc, lsn, epoch, op, count = _HEADER.unpack_from(buf, off)
    if magic != MAGIC or op not in (OP_UPSERT, OP_DELETE):
        return None
    n_pay = 8 * count * (2 if op == OP_UPSERT else 1)
    end = off + _HEADER.size + n_pay
    if end > len(buf):
        return None
    if zlib.crc32(buf[off + 8: end]) & 0xFFFFFFFF != crc:
        return None
    keys = np.frombuffer(buf, np.float64, count, off + _HEADER.size)
    vals = (np.frombuffer(buf, np.int64, count,
                          off + _HEADER.size + 8 * count)
            if op == OP_UPSERT else None)
    return dict(lsn=lsn, epoch=epoch, op=op, keys=keys, vals=vals), end


def read_records(d: str, from_lsn: int = 0) -> list[dict]:
    """Every durable record with lsn >= `from_lsn`, in lsn order, stopping
    at the first corruption or lsn gap (torn-tail truncation).  Segments
    wholly below `from_lsn` (already checkpointed + purged or purgeable)
    are skipped without reading.

    One deliberate continuation: a torn tail followed by a segment that
    starts at EXACTLY the next expected lsn is read through — that is the
    signature of a writer resumed by recovery (the torn bytes were a dead
    record whose lsn the resumed writer re-issued in a fresh segment), not
    of corruption."""
    segs = list_segments(d)
    out: list[dict] = []
    expect = None
    for i, (start, path) in enumerate(segs):
        nxt = segs[i + 1][0] if i + 1 < len(segs) else None
        if nxt is not None and nxt <= from_lsn:
            continue                      # fully below the replay window
        if expect is not None and start != expect:
            break                         # gap between segments: stop here
        with open(path, "rb") as f:
            buf = f.read()
        off, lsn, torn = 0, start, False
        while True:
            dec = _decode_one(buf, off)
            if dec is None:
                torn = off < len(buf)     # undecodable trailing bytes
                break
            rec, off = dec
            if rec["lsn"] != lsn:
                torn = True
                break
            lsn += 1
            if rec["lsn"] >= from_lsn:
                out.append(rec)
        expect = lsn
        if torn and nxt != lsn:
            break                         # torn tail with no resumed segment
    return out


def _valid_prefix_len(path: str, start_lsn: int) -> int:
    """Byte length of the decodable record prefix of one segment file."""
    with open(path, "rb") as f:
        buf = f.read()
    off, lsn = 0, start_lsn
    while True:
        dec = _decode_one(buf, off)
        if dec is None or dec[0]["lsn"] != lsn:
            return off
        off, lsn = dec[1], lsn + 1


class WalWriter:
    """Single-shard append-only writer.  One writer thread per the
    online-index threading contract; the durability manager serializes
    rotate/purge against appends with its own lock."""

    def __init__(self, d: str, fsync: str = "interval",
                 fsync_interval_s: float = 0.05, start_lsn: int = 0):
        import time
        self._time = time
        self.dir = d
        self.fsync = fsync
        self.fsync_interval_s = fsync_interval_s
        self.next_lsn = start_lsn
        self._seg_start = start_lsn
        self._last_sync = 0.0
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, _seg_name(start_lsn))
        # a crashed writer can leave this very path holding a torn record
        # (mid-record kill on a segment's FIRST record); appending after
        # garbage would strand every new record behind it, so clip the
        # file to its valid prefix before reopening
        if os.path.exists(path) and os.path.getsize(path):
            keep = _valid_prefix_len(path, start_lsn)
            if keep < os.path.getsize(path):
                with open(path, "r+b") as f:
                    f.truncate(keep)
        self._f = open(path, "ab")

    def append(self, op: int, keys: np.ndarray, vals: np.ndarray | None,
               epoch: int) -> int:
        """Write one record; returns its lsn.  The python buffer is always
        flushed to the OS before returning (in-process crash safety);
        fsync follows the configured policy."""
        rec = encode_record(self.next_lsn, epoch, op, keys, vals)
        if hooks.armed("wal.mid_record"):
            # test-only shape: land half the record, offer to die, then
            # finish — the production path below is a single write
            half = len(rec) // 2
            self._f.write(rec[:half])
            self._f.flush()
            hooks.crash_point("wal.mid_record")
            self._f.write(rec[half:])
        else:
            self._f.write(rec)
        self._f.flush()
        if self.fsync == "always":
            os.fsync(self._f.fileno())
        elif self.fsync == "interval":
            now = self._time.monotonic()
            if now - self._last_sync >= self.fsync_interval_s:
                os.fsync(self._f.fileno())
                self._last_sync = now
        self.next_lsn += 1
        return self.next_lsn - 1

    def sync(self) -> None:
        """Explicit durability barrier: flush + fsync regardless of policy
        (the facade's `flush()` calls this)."""
        self._f.flush()
        if self.fsync != "off":
            os.fsync(self._f.fileno())

    def rotate(self) -> None:
        """Close the active segment and start a fresh one at the current
        lsn (no-op when the active segment is empty).  Called at
        checkpoint time so the just-checkpointed prefix becomes a CLOSED
        segment that `purge_upto` can delete."""
        if self.next_lsn == self._seg_start:
            return
        self.sync()
        self._f.close()
        self._seg_start = self.next_lsn
        self._f = open(os.path.join(self.dir, _seg_name(self.next_lsn)),
                       "ab")

    def purge_upto(self, watermark: int) -> int:
        """Delete closed segments whose entire lsn range is below
        `watermark` (= records already captured by every retained
        checkpoint).  Returns the number of segments removed."""
        return purge_dir_upto(self.dir, watermark,
                              active_start=self._seg_start)

    def close(self) -> None:
        if not self._f.closed:
            self.sync()
            self._f.close()

    def abandon(self) -> None:
        """Crash simulation: stop using the writer WITHOUT the closing
        sync.  Appended records were flushed to the OS per append, so
        they stay readable — exactly the state a killed process leaves."""
        if not self._f.closed:
            self._f.close()     # close() flushes the (empty) buffer only


def purge_dir_upto(d: str, watermark: int,
                   active_start: int | None = None) -> int:
    """Segment GC for one shard dir: drop every segment whose range ends
    at or below `watermark` (range end = next segment's start).  A writer
    passes its active segment's start so the live file is never a purge
    candidate; for stale dirs (no writer — the shard count shrank) every
    segment is eligible."""
    segs = list_segments(d)
    n = 0
    for i, (start, path) in enumerate(segs):
        if active_start is not None and start >= active_start:
            break
        end = segs[i + 1][0] if i + 1 < len(segs) else None
        if end is None or end > watermark:
            break
        os.remove(path)
        n += 1
    return n


def end_lsn(d: str) -> int:
    """One past the last durable lsn in a shard dir (0 when empty) —
    where a continuing writer must resume numbering."""
    recs = read_records(d)
    if recs:
        return recs[-1]["lsn"] + 1
    segs = list_segments(d)
    return segs[0][0] if segs else 0
