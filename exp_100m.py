"""100M-read scaling anchor (BASELINE.md; ROADMAP reach item 1).

Generates a 100M x 100 bp WGS-like FASTQ (vectorized, fixed-width
headers), encodes it (wall time, peak RSS, bits/base), decodes, and
validates with the streaming validator. Prints one JSON line naming the
device the encode ran on.

Usage: python exp_100m.py [gen|encode|decode|all]
"""
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np

N = int(os.environ.get("PGRC_100M_READS", 100_000_000))
L = 100
from bench import bench_dir  # noqa: E402

tmp = bench_dir()
src = os.path.join(tmp, f"anchor_{N}.fastq")
out = os.path.join(tmp, "anchor.pgtc")


def generate():
    """Vectorized chunked writer: fixed 216-byte records."""
    from pgrc.utils import dna

    rng = np.random.default_rng(17)
    glen = N * L // 40
    genome = rng.integers(0, 4, size=glen, dtype=np.uint8)
    chunk = 1_000_000
    rec = 12 + L + 3 + L + 1  # @rXXXXXXXXX\n seq\n +\n qual\n = 216 at L=100
    t0 = time.time()
    with open(src, "wb") as f:
        for lo in range(0, N, chunk):
            n = min(chunk, N - lo)
            starts = rng.integers(0, glen - L, size=n)
            codes = genome[starts[:, None] + np.arange(L)[None, :]]
            flip = rng.random(n) < 0.5
            codes[flip] = dna.COMPL_VAL[codes[flip][:, ::-1]]
            err = rng.random(codes.shape) < 0.004
            codes[err] = (codes[err] + rng.integers(1, 4, size=int(err.sum()))) % 4
            buf = np.empty((n, rec), dtype=np.uint8)
            buf[:, 0] = ord("@")
            buf[:, 1] = ord("r")
            ids = np.arange(lo, lo + n, dtype=np.int64)
            for d in range(9):
                buf[:, 2 + d] = (ids // 10 ** (8 - d)) % 10 + ord("0")
            buf[:, 11] = 10
            buf[:, 12 : 12 + L] = dna.VAL2SYM[codes]
            buf[:, 112] = 10
            buf[:, 113] = ord("+")
            buf[:, 114] = 10
            buf[:, 115 : 115 + L] = ord("I")
            lowq = rng.random(n) < 0.12
            buf[lowq, 115 + L // 2 : 115 + L] = ord("#")
            buf[:, 215] = 10
            f.write(buf.tobytes())
            if lo % 10_000_000 == 0:
                print(f"  gen {lo // 1_000_000}M... {time.time() - t0:.0f}s",
                      flush=True)
    print(f"generated {src} in {time.time() - t0:.0f}s", flush=True)


def encode():
    from pgrc.archive import encoder as enc
    from pgrc.config import PgRCParams
    from pgrc.device import describe

    t0 = time.time()
    s = enc.encode(PgRCParams(src_fastq=src, output=out))
    dt = time.time() - t0
    bases = s.reads_total * s.read_len
    return {
        "device": describe(),
        "reads": s.reads_total,
        "encode_s": round(dt, 1),
        "encode_mbases_s": round(bases / 1e6 / dt, 2),
        "bits_per_base": round(s.archive_bytes * 8 / bases, 4),
        "archive_bytes": s.archive_bytes,
        "stage_times_s": {k: round(v, 1) for k, v in s.stage_times.items()},
        "encode_peak_rss_mb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1),
    }


def decode_validate():
    from pgrc.archive import decoder

    t0 = time.time()
    rep = decoder.validate(out, src)
    return {
        "validate_s": round(time.time() - t0, 1),
        "validate_ok": rep["errors"] == 0,
        "validate_reads": rep["reads"],
    }


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "all"
    res = {"n": N}
    if mode in ("gen", "all") and not os.path.exists(src):
        generate()
    if mode in ("encode", "all"):
        res.update(encode())
    if mode in ("decode", "all"):
        res.update(decode_validate())
    print(json.dumps(res))
