"""PGTC stream container: headers, raw-store fallback, batched compression.

Mirrors the reference's per-stream header {rawLen, compLen, coderType}
(coders/CodersLib.cpp:315-380) and the collective parallel batch compress /
decompress (writeCompressedCollectiveParallel / readCompressedCollectiveParallel,
CodersLib.cpp:503-641) via a thread pool (liblzma and the native coders release the GIL).

Stream record layout (little-endian):
    u8 coder_id | u8 p1 | u8 p2 | varint raw_len | varint comp_len | payload
A STORE record is emitted whenever compression does not shrink the payload.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from ..utils.errors import PgtcFormatError
from ..utils.varint import read_varint, write_varint
from . import codecs
from .codecs import Codec

_MAX_WORKERS = 8

# -T stream-dump mode: when set, every compressed stream's RAW bytes are
# also written to this directory as NNN_label.bin for external diffing
# (the dump_after_decompression debugging role, coders/CodersLib.cpp:12-15)
_DUMP_DIR: str | None = None
_DUMP_SEQ = 0


def set_threads(n: int) -> None:
    """Set the stream compression pool width (reference numberOfThreads,
    utils/helper.cpp; 0 keeps the default)."""
    global _MAX_WORKERS
    if n > 0:
        _MAX_WORKERS = n


def set_stream_dump_dir(path: str | None) -> None:
    """Enable/disable -T raw-stream dumping (None disables)."""
    global _DUMP_DIR, _DUMP_SEQ
    _DUMP_DIR = path
    _DUMP_SEQ = 0
    if path:
        import os

        os.makedirs(path, exist_ok=True)


def _dump_stream(label: str, data: bytes) -> None:
    global _DUMP_SEQ
    if _DUMP_DIR is None:
        return
    import os
    import re

    name = re.sub(r"[^A-Za-z0-9_.-]+", "_", label)
    with open(os.path.join(_DUMP_DIR, f"{_DUMP_SEQ:03d}_{name}.bin"), "wb") as f:
        f.write(data)
    _DUMP_SEQ += 1


@dataclass
class CompressionJob:
    """One named stream to compress (reference CompressionJob, CodersLib.h:186)."""

    label: str
    data: bytes
    codec: Codec
    # optional selector alternatives; the smallest result wins
    alternatives: list[Codec] = field(default_factory=list)


def _compress_one(job: CompressionJob) -> bytes:
    import time

    from ..utils import logchan

    t0 = time.monotonic()
    candidates = [job.codec, *job.alternatives]
    if len(job.data) > 2 * codecs.BLOCK_SIZE:
        # big stream: swap single-shot LZMA for the parallel-blocks
        # wrapper (intra-stream thread parallelism, small ratio loss)
        candidates = [
            Codec(codecs.BLOCKED, c.coder_id, c.p1)
            if c.coder_id == codecs.LZMA_CODER and c.p2 <= 1
            else c
            for c in candidates
        ]
    best_codec, best = codecs.select_best(candidates, job.data)
    rec = bytearray()
    if len(best) >= len(job.data):
        best_codec, best = Codec(codecs.STORE), job.data
    if job.data:
        # per-stream compression log (reference CodersLib.cpp:216-229)
        logchan.devout.write(
            f"\t{job.label}... coder {best_codec.coder_id} compressed "
            f"{len(job.data)} bytes to {len(best)} bytes "
            f"(ratio {len(best) / len(job.data):.3f}) in "
            f"{int((time.monotonic() - t0) * 1000)} msec.\n"
        )
    rec.append(best_codec.coder_id)
    rec.append(best_codec.p1 & 0xFF)
    rec.append(best_codec.p2 & 0xFF)
    write_varint(rec, len(job.data))
    write_varint(rec, len(best))
    rec.extend(best)
    return bytes(rec)


def write_streams(out, jobs: list[CompressionJob]) -> list[int]:
    """Compress all jobs in parallel, write records in order; returns sizes."""
    if not jobs:
        return []
    for job in jobs:
        _dump_stream(job.label, job.data)
    with ThreadPoolExecutor(max_workers=min(_MAX_WORKERS, len(jobs))) as ex:
        records = list(ex.map(_compress_one, jobs))
    sizes = []
    for rec in records:
        out.write(rec)
        sizes.append(len(rec))
    return sizes


def write_stream(out, job: CompressionJob) -> int:
    _dump_stream(job.label, job.data)
    rec = _compress_one(job)
    out.write(rec)
    return len(rec)


def _read_record(buf: memoryview, pos: int) -> tuple[Codec, int, bytes, int]:
    try:
        coder_id = buf[pos]
        p1 = buf[pos + 1]
        p2 = buf[pos + 2]
        raw_len, pos = read_varint(buf, pos + 3)
        comp_len, pos = read_varint(buf, pos)
    except (IndexError, ValueError) as e:
        raise PgtcFormatError(f"truncated stream record at offset {pos}") from e
    if pos + comp_len > len(buf):
        raise PgtcFormatError(
            f"stream record at offset {pos} claims {comp_len} payload bytes "
            f"but only {len(buf) - pos} remain"
        )
    payload = bytes(buf[pos : pos + comp_len])
    return Codec(coder_id, p1, p2), raw_len, payload, pos + comp_len


def _decompress_record(codec: Codec, payload: bytes, raw_len: int) -> bytes:
    try:
        out = codec.decompress(payload, raw_len)
    except PgtcFormatError:
        raise
    except Exception as e:  # lzma/rANS corruption errors, unknown coder ids
        raise PgtcFormatError(f"stream payload does not decode: {e}") from e
    if len(out) != raw_len:
        raise PgtcFormatError(
            f"stream decoded to {len(out)} bytes, header says {raw_len}"
        )
    return out


class StreamReader:
    """Sequential reader over a PGTC buffer with threaded batch decode."""

    def __init__(self, buf: bytes | memoryview, pos: int = 0):
        self.buf = memoryview(buf)
        self.pos = pos

    def read_one(self) -> bytes:
        codec, raw_len, payload, self.pos = _read_record(self.buf, self.pos)
        return _decompress_record(codec, payload, raw_len)

    def read_many(self, count: int) -> list[bytes]:
        items = []
        for _ in range(count):
            codec, raw_len, payload, self.pos = _read_record(self.buf, self.pos)
            items.append((codec, raw_len, payload))
        with ThreadPoolExecutor(max_workers=min(_MAX_WORKERS, max(count, 1))) as ex:
            return list(ex.map(lambda t: _decompress_record(t[0], t[2], t[1]),
                               items))
