import numpy as np

from pgrc.align import matcher
from pgrc.core import packed


def make_pg_and_reads(n_reads, read_len, pg_len, n_mis, seed=0, rc_frac=0.3):
    rng = np.random.default_rng(seed)
    pg = rng.integers(0, 4, size=pg_len, dtype=np.uint8)
    starts = rng.integers(0, pg_len - read_len, size=n_reads)
    reads = pg[starts[:, None] + np.arange(read_len)[None, :]].copy()
    # inject mismatches
    mis_counts = rng.integers(0, n_mis + 1, size=n_reads)
    for i in range(n_reads):
        pos = rng.choice(read_len, size=mis_counts[i], replace=False)
        reads[i, pos] = (reads[i, pos] + rng.integers(1, 4, size=pos.size)) % 4
    rc = rng.random(n_reads) < rc_frac
    reads[rc] = packed.revcomp_codes_matrix(reads[rc])
    return pg, reads, starts, rc, mis_counts


def test_exact_reads_all_match():
    pg, reads, starts, rc, _ = make_pg_and_reads(500, 100, 20000, 0, seed=1)
    idx = matcher.build_index(pg, bits=16)
    res = matcher.match_reads(reads, idx, pg, max_mismatches=33)
    assert (res.mis != 255).mean() > 0.99
    matched = res.mis != 255
    # verify claimed matches decode correctly
    for i in np.nonzero(matched)[0][:100]:
        window = pg[res.pos[i] : res.pos[i] + 100]
        decoded = window if not res.rc[i] else packed.revcomp_codes_matrix(window[None])[0]
        assert (decoded != reads[i]).sum() == res.mis[i]


def test_mismatch_reads_match_with_reported_count():
    pg, reads, starts, rc, mis_counts = make_pg_and_reads(400, 100, 15000, 3, seed=2)
    idx = matcher.build_index(pg, bits=16)
    res = matcher.match_reads(reads, idx, pg, max_mismatches=33)
    matched = res.mis != 255
    assert matched.mean() > 0.9  # low-error reads should almost all match
    for i in np.nonzero(matched)[0]:
        window = pg[res.pos[i] : res.pos[i] + 100]
        decoded = window if not res.rc[i] else packed.revcomp_codes_matrix(window[None])[0]
        assert (decoded != reads[i]).sum() == res.mis[i]
        assert res.mis[i] <= mis_counts[i]  # found best-or-equal alignment


def test_random_reads_do_not_match_spuriously():
    rng = np.random.default_rng(3)
    pg = rng.integers(0, 4, size=30000, dtype=np.uint8)
    junk = rng.integers(0, 4, size=(100, 100), dtype=np.uint8)
    idx = matcher.build_index(pg, bits=16)
    res = matcher.match_reads(junk, idx, pg, max_mismatches=10)
    # random 100-mers vs random 30kb pg: ~75 expected mismatches; none <= 10
    assert (res.mis == 255).all()


def test_window_hash_consistency():
    rng = np.random.default_rng(4)
    seq = rng.integers(0, 4, size=500, dtype=np.uint8)
    k = 32
    h = matcher._window_hashes(seq, k)
    pows = np.array(
        [pow(int(matcher.HASH_BASE), k - 1 - t, 1 << 32) for t in range(k)],
        dtype=np.uint32,
    )
    for i in (0, 1, 7, 100, 468):
        direct = np.uint32((seq[i : i + k].astype(np.uint64) * pows.astype(np.uint64)).sum() & 0xFFFFFFFF)
        assert h[i] == direct, i


def test_wide_probe_equivalent():
    """The wide (i64 position) probe variant must produce identical matches
    to the standard i32 path (pg-config.h:39-44 widening analog)."""
    import numpy as np
    from pgrc.align import matcher as am

    rng = np.random.default_rng(5)
    pg = rng.integers(0, 4, size=20000).astype(np.uint8)
    starts = rng.integers(0, pg.size - 80, size=500)
    reads = pg[starts[:, None] + np.arange(80)[None, :]].copy()
    err = rng.random(reads.shape) < 0.01
    reads[err] = (reads[err] + 1) % 4
    index = am.build_index(pg, k=24, bits=16)
    r1 = am.match_reads(reads, index, pg, max_mismatches=20)
    r2 = am.match_reads(reads, index, pg, max_mismatches=20, force_wide=True)
    assert np.array_equal(r1.pos, r2.pos)
    assert np.array_equal(r1.mis, r2.mis)
    assert np.array_equal(r1.rc, r2.rc)
    assert (r1.pos >= 0).mean() > 0.9


def test_blocked_index_probe():
    """A wide pg whose sampled index exceeds the join program limit is
    probed in index BLOCKS merged by (mismatches, position); with tiny
    forced blocks the result must still find (essentially) every read —
    block boundaries may pick a different equal-quality position, so the
    check is on match quality, not position identity."""
    import numpy as np
    from pgrc.align import matcher as am

    rng = np.random.default_rng(6)
    pg = rng.integers(0, 4, size=20000).astype(np.uint8)
    starts = rng.integers(0, pg.size - 80, size=400)
    reads = pg[starts[:, None] + np.arange(80)[None, :]].copy()
    err = rng.random(reads.shape) < 0.01
    reads[err] = (reads[err] + 1) % 4
    index = am.build_index(pg, k=24, bits=16)
    r1 = am.match_reads(reads, index, pg, max_mismatches=20, force_wide=True)
    r2 = am.match_reads(reads, index, pg, max_mismatches=20, force_wide=True,
                        index_block=512)  # ~10 blocks of the 5k-entry index
    assert (r2.mis != 255).mean() >= (r1.mis != 255).mean() - 0.01
    # every blocked match must verify exactly
    from pgrc.core import packed as pk
    for i in np.nonzero(r2.mis != 255)[0][:100]:
        win = pg[r2.pos[i] : r2.pos[i] + 80]
        dec = win if not r2.rc[i] else pk.revcomp_codes_matrix(win[None])[0]
        assert (dec != reads[i]).sum() == r2.mis[i]


def test_burst_error_rescue():
    """Reads with an error burst that kills every contiguous k-mer anchor
    must still match via the interleaved rescue pass (the
    InterleavedReadsApproxMatcher insurance role)."""
    import numpy as np
    from pgrc.align import matcher as am

    rng = np.random.default_rng(7)
    # repeat-heavy pg: tandem copies of a short unit plus unique flanks
    unit = rng.integers(0, 4, size=350).astype(np.uint8)
    pg = np.concatenate([rng.integers(0, 4, size=5000).astype(np.uint8)]
                        + [unit] * 30
                        + [rng.integers(0, 4, size=5000).astype(np.uint8)])
    L, k = 100, 24
    starts = rng.integers(0, pg.size - L, size=300)
    reads = pg[starts[:, None] + np.arange(L)[None, :]].copy()
    # plant error bursts: every k-th symbol corrupted so every contiguous
    # k-window contains >= 1 error, but alternate symbols stay clean
    for r in range(0, 300, 2):
        hit = np.arange(1, L, k // 2 * 2 + 1)  # odd positions, spaced < k
        reads[r, hit] = (reads[r, hit] + 1) % 4
    index = am.build_index(pg, k=k, bits=16)
    res = am.match_reads(reads, index, pg, max_mismatches=L // 3)
    frac = (res.pos >= 0).mean()
    # clean reads all match; burst reads must be rescued
    assert frac > 0.97, frac
    # matches must be honest: reconstructable within the mismatch budget
    ok = np.nonzero(res.pos >= 0)[0]
    win = pg[res.pos[ok, None] + np.arange(L)[None, :]]
    from pgrc.core import packed as pk
    rr = reads[ok].copy()
    rc = res.rc[ok]
    rr[rc] = pk.revcomp_codes_matrix(rr[rc])
    mis = (win != rr).sum(axis=1)
    assert (mis <= L // 3).all()
