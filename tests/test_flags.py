"""Coverage for the historically-untested expert flags:
full quality mode (-Q), prematch accept (-l), and a leftover-heavy input
that exercises the interleaved rescue pass at scale.
"""
import time

import numpy as np
import pytest

from pgrc.archive import decoder, encoder
from pgrc.config import PgRCParams
from pgrc.core import fastq
from pgrc.utils import dna

from test_roundtrip import synth_fastq


def _write_fastq(path, codes, qual):
    with open(path, "wb") as f:
        for i in range(codes.shape[0]):
            f.write(b"@r%d\n" % i)
            f.write(dna.VAL2SYM[codes[i]].tobytes() + b"\n+\n")
            f.write(qual[i].tobytes() + b"\n")


def test_full_quality_mode_classifier(tmp_path):
    """Full (-Q) mode: arithmetic mean of per-base correct probability vs
    the error limit (reference qualityScore2correctProbArithAvg,
    utils/helper.cpp:452-475) — checked against a direct computation and
    distinct from the simplified single-char test."""
    rng = np.random.default_rng(5)
    n, L = 600, 80
    codes = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    # quality: uniform random phred in '#'(2) .. 'I'(40)
    qual = rng.integers(ord("#"), ord("I") + 1, size=(n, L)).astype(np.uint8)
    # make the simplified test disagree with the full test on purpose:
    # great suffix char but awful everywhere else for some rows
    qual[:100] = ord("#")
    qual[:100, int(L * (1 - 0.12))] = ord("I")
    path = str(tmp_path / "q.fastq")
    _write_fastq(path, codes, qual)

    reads = fastq.read_any(path)
    full = fastq.quality_high_mask(reads, 0.12, simplified_suffix_mode=False)
    simp = fastq.quality_high_mask(reads, 0.12, simplified_suffix_mode=True)
    probs = dna.QUALITY2PROB[qual]
    want = (1.0 - probs.mean(axis=1)) <= 0.12
    assert np.array_equal(full, want)
    assert simp[:100].all() and not full[:100].any()  # modes truly differ

    # the full-mode division flows through the chunked/native ingest too
    div = fastq.read_divided(path, None, False, 0.12, False)
    assert np.array_equal(div.hq_mask, want)

    # end-to-end: -Q encode round-trips
    out = str(tmp_path / "q.pgtc")
    encoder.encode(PgRCParams(src_fastq=path, output=out,
                              simplified_suffix_mode=False))
    assert decoder.validate(out, path)["errors"] == 0


def test_prematch_accept_mis_flag(tmp_path):
    """-l N (prematch accept threshold, reference preReadsExactMatchingChars
    chain): a nonzero accept_mis must still produce a valid archive, and a
    large accept threshold must not reduce the matched fraction to zero."""
    path = str(tmp_path / "l.fastq")
    synth_fastq(path, 1200, 80, 8000, seed=31)
    outs = {}
    for lval in (0, 3):
        out = str(tmp_path / f"l{lval}.pgtc")
        p = PgRCParams(src_fastq=path, output=out)
        p.prematch_accept_mis = lval
        stats = encoder.encode(p)
        assert decoder.validate(out, path)["errors"] == 0
        outs[lval] = stats
    assert outs[3].matched_count > 0


def test_leftover_heavy_rescue(tmp_path):
    """High-divergence input: a large fraction of reads carries dense
    errors (every ~12 bp) that kill every contiguous k-mer anchor, forcing
    them through pass 2 and the interleaved rescue pass. Pins that the
    rescue path stays vectorized-fast on a LARGE leftover set (the r4
    concern: matcher.py's per-offset loop becoming a serial cliff) and
    that the archive still round-trips."""
    rng = np.random.default_rng(7)
    n, L = 4000, 100
    genome = rng.integers(0, 4, size=40_000, dtype=np.uint8)
    starts = rng.integers(0, genome.size - L, size=n)
    codes = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    # 30% of reads: dense periodic errors (kills all 32-mer anchors)
    bad = rng.random(n) < 0.3
    err_cols = np.arange(3, L, 11)
    sub = codes[bad]
    sub[:, err_cols] = (sub[:, err_cols]
                        + rng.integers(1, 4, size=(sub.shape[0],
                                                   err_cols.size))) % 4
    codes[bad] = sub
    qual = np.full((n, L), ord("I"), dtype=np.uint8)
    # half the reads are low-quality so there IS a matching stage
    qual[rng.random(n) < 0.5, L // 2:] = ord("#")
    path = str(tmp_path / "div.fastq")
    _write_fastq(path, codes, qual)
    out = str(tmp_path / "div.pgtc")
    t0 = time.time()
    stats = encoder.encode(PgRCParams(src_fastq=path, output=out))
    wall = time.time() - t0
    assert decoder.validate(out, path)["errors"] == 0
    # a serial cliff here showed up as minutes; generous bound that still
    # catches quadratic blowup on 1000+ leftovers
    assert wall < 120, f"leftover-heavy encode took {wall:.1f}s"


def test_rescue_pass_large_set_bounded():
    """Direct cost pin on the interleaved rescue: thousands of leftover
    reads must process in seconds (vectorized over reads, looped only
    over offsets x cap)."""
    from pgrc.align import matcher as am

    rng = np.random.default_rng(9)
    pg = rng.integers(0, 4, size=60_000).astype(np.uint8)
    n, L = 5000, 100
    starts = rng.integers(0, pg.size - L, size=n)
    reads = pg[starts[:, None] + np.arange(L)[None, :]].copy()
    err_cols = np.arange(1, L, 14)  # dense errors, all on ODD columns
    reads[:, err_cols] = (reads[:, err_cols] + 1) % 4
    t0 = time.time()
    mis, pos = am._interleaved_rescue(reads, pg, 16, max_mis=33)
    wall = time.time() - t0
    assert wall < 60, f"rescue of {n} reads took {wall:.1f}s"
    found = (mis != 255).mean()
    # errors on odd columns leave even-parity interleaved anchors intact,
    # but the k1=2 pg sampling indexes even pg positions only, so only the
    # ~half of reads aligned at even pg positions can anchor — expect ~49%
    assert found > 0.4, f"rescue found only {found:.2%}"
