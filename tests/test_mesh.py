"""Multi-device sharding tests: the 8-virtual-device CPU mesh must produce
byte-identical results to the 1-device path (the reference's OpenMP loops map
to collectives without changing any greedy decision, SURVEY §2.8)."""
import os
import tempfile

import numpy as np
import pytest

from pgrc.align import matcher as am
from pgrc.archive import decoder, encoder
from pgrc.config import PgRCParams
from pgrc.overlap import greedy_scs
from pgrc.parallel import mesh as pmesh
from pgrc.utils import dna


def _synth_reads(n, L, seed, err=0.01, coverage=30):
    rng = np.random.default_rng(seed)
    gl = max(n * L // coverage, 4 * L)
    genome = rng.integers(0, 4, size=gl, dtype=np.uint8)
    starts = rng.integers(0, gl - L, size=n)
    codes = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    e = rng.random(codes.shape) < err
    codes[e] = (codes[e] + rng.integers(1, 4, size=int(e.sum()))) % 4
    return codes


def _write_fastq(path, codes):
    L = codes.shape[1]
    with open(path, "wb") as f:
        for i in range(codes.shape[0]):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, dna.VAL2SYM[codes[i]].tobytes(),
                                            b"I" * L))


@pytest.fixture(scope="module")
def mesh8():
    import jax

    assert len(jax.devices()) >= 8, "conftest provisions 8 virtual CPU devices"
    return pmesh.make_mesh(8)


def test_find_overlaps_mesh_identical(mesh8):
    codes = _synth_reads(3000, 60, seed=11)
    r1 = greedy_scs.find_overlaps(codes)
    r8 = greedy_scs.find_overlaps(codes, mesh=mesh8)
    np.testing.assert_array_equal(r1.succ, r8.succ)
    np.testing.assert_array_equal(r1.overlap, r8.overlap)


def test_match_reads_mesh_identical(mesh8):
    rng = np.random.default_rng(5)
    pg = rng.integers(0, 4, size=200_000, dtype=np.uint8)
    L = 80
    starts = rng.integers(0, pg.size - L, size=4000)
    reads = pg[starts[:, None] + np.arange(L)[None, :]].copy()
    e = rng.random(reads.shape) < 0.02
    reads[e] = (reads[e] + rng.integers(1, 4, size=int(e.sum()))) % 4
    index = am.build_index(pg, bits=18)
    m1 = am.match_reads(reads, index, pg, max_mismatches=26)
    m8 = am.match_reads(reads, index, pg, max_mismatches=26, mesh=mesh8)
    np.testing.assert_array_equal(m1.pos, m8.pos)
    np.testing.assert_array_equal(m1.rc, m8.rc)
    np.testing.assert_array_equal(m1.mis, m8.mis)


def test_encode_mesh_archive_identical(mesh8):
    """The production encoder over an 8-device mesh writes the byte-identical
    archive of the 1-device run, and it round-trips."""
    codes = _synth_reads(1500, 48, seed=3)
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "in.fastq")
        _write_fastq(src, codes)
        out1 = os.path.join(d, "a1.pgtc")
        out8 = os.path.join(d, "a8.pgtc")
        encoder.encode(PgRCParams(src_fastq=src, output=out1))
        encoder.encode(PgRCParams(src_fastq=src, output=out8), mesh=mesh8)
        with open(out1, "rb") as f:
            b1 = f.read()
        with open(out8, "rb") as f:
            b8 = f.read()
        assert b1 == b8
        rep = decoder.validate(out8, src)
        assert not rep["errors"], rep


def test_find_overlaps_mesh_with_compaction_matches_single():
    """A high-coverage input large enough that the active set collapses
    below the compaction ladder on an 8-device mesh: the sharded path must
    compact (per-device local tables, scatter/gather routing) and still
    produce exactly the single-device links."""
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, size=20_000, dtype=np.uint8)
    starts = rng.integers(0, genome.size - 60, size=40_000)
    codes = genome[starts[:, None] + np.arange(60)[None, :]].astype(np.uint8)

    res1 = greedy_scs.find_overlaps(codes, coef=1.0)
    m = pmesh.make_mesh(8)
    # fresh caches so the mesh run cannot reuse single-device programs
    res8 = greedy_scs.find_overlaps(codes, coef=1.0, mesh=m)
    assert np.array_equal(res1.succ, res8.succ)
    assert np.array_equal(res1.overlap, res8.overlap)
