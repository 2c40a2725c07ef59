"""Precompile warm-up: populate the persistent XLA compilation cache.

The first time a machine sees a device program's shape it compiles it
(compile cost on the H100 is not measured yet); the shapes are bucketed, so
ONE warm-up encode per target input scale precompiles everything later
encodes of that scale need. Run once after installation (or before a
latency-sensitive batch):

    python -m pgrc.warmup            # default ladder: 200k, 2M reads
    python -m pgrc.warmup 10000000   # add the 10M-scale shapes

The inputs are synthetic WGS-like FASTQ (40x coverage) generated in a
temp dir; archives are discarded. Compiled programs persist in
$JAX_COMPILATION_CACHE_DIR when it is set, else in the checkout's
`.jax_cache` (see pgrc/device.py).
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np


def _synth(path: str, n_reads: int, read_len: int = 100, seed: int = 5) -> None:
    from .utils import dna

    rng = np.random.default_rng(seed)
    glen = max(n_reads * read_len // 40, 200_000)
    genome = rng.integers(0, 4, size=glen, dtype=np.uint8)
    chunk = 1_000_000
    with open(path, "wb") as f:
        for lo in range(0, n_reads, chunk):
            n = min(chunk, n_reads - lo)
            starts = rng.integers(0, glen - read_len, size=n)
            codes = genome[starts[:, None] + np.arange(read_len)[None, :]]
            flip = rng.random(n) < 0.5
            codes[flip] = dna.COMPL_VAL[codes[flip][:, ::-1]]
            err = rng.random(codes.shape) < 0.004
            codes[err] = (codes[err] + rng.integers(1, 4, size=int(err.sum()))) % 4
            rec = 3 + 1 + read_len + 1 + 2 + read_len + 1
            buf = np.empty((n, rec), dtype=np.uint8)
            buf[:, 0:3] = [ord("@"), ord("w"), ord("0")]
            buf[:, 3] = 10
            buf[:, 4 : 4 + read_len] = dna.VAL2SYM[codes]
            buf[:, 4 + read_len] = 10
            buf[:, 5 + read_len] = ord("+")
            buf[:, 6 + read_len] = 10
            buf[:, 7 + read_len : 7 + 2 * read_len] = ord("I")
            lowq = rng.random(n) < 0.12
            buf[lowq, 7 + read_len + read_len // 2 : 7 + 2 * read_len] = ord("#")
            buf[:, 7 + 2 * read_len] = 10
            f.write(buf.tobytes())


def warmup(sizes=(200_000, 2_000_000), read_len: int = 100) -> None:
    from .archive import encoder
    from .config import PgRCParams

    with tempfile.TemporaryDirectory() as d:
        for n in sizes:
            src = os.path.join(d, f"w{n}.fastq")
            _synth(src, n, read_len)
            t0 = time.time()
            encoder.encode(PgRCParams(src_fastq=src,
                                      output=os.path.join(d, "w.pgtc")))
            print(f"warmup {n} reads x {read_len} bp: {time.time() - t0:.1f}s "
                  f"(compiles now cached)", flush=True)
            os.unlink(src)


if __name__ == "__main__":
    sizes = [int(a) for a in sys.argv[1:]] or [200_000, 2_000_000]
    warmup(sizes)
