"""End-to-end archive round-trip tests in all modes (the PGTC fidelity
contract, DESIGN.md): ORD modes byte-identical, non-ord modes permutation
with pair association preserved."""
import numpy as np
import pytest

from pgrc.archive import decoder, encoder
from pgrc.config import PgRCParams
from pgrc.utils import dna


def synth_fastq(path, n_reads, read_len, genome_len, seed, n_frac=0.02,
                lowq_frac=0.2, mis_rate=0.01):
    """Genome-sampled reads with errors, N bases, mixed qualities."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    starts = rng.integers(0, genome_len - read_len, size=n_reads)
    codes = genome[starts[:, None] + np.arange(read_len)[None, :]].copy()
    # strand flips
    flip = rng.random(n_reads) < 0.5
    codes[flip] = dna.COMPL_VAL[codes[flip][:, ::-1]]
    # sequencing errors
    err = rng.random(codes.shape) < mis_rate
    codes[err] = (codes[err] + rng.integers(1, 4, size=int(err.sum()))) % 4
    # N bases in a fraction of reads
    n_rows = rng.random(n_reads) < n_frac
    for i in np.nonzero(n_rows)[0]:
        k = rng.integers(1, 4)
        codes[i, rng.choice(read_len, size=k, replace=False)] = dna.N
    # qualities: high 'I' except low-quality reads get '#' tails
    qual = np.full((n_reads, read_len), ord("I"), dtype=np.uint8)
    lowq = rng.random(n_reads) < lowq_frac
    qual[lowq, read_len // 2:] = ord("#")
    with open(path, "wb") as f:
        for i in range(n_reads):
            f.write(b"@r%d\n" % i)
            f.write(dna.VAL2SYM[codes[i]].tobytes() + b"\n+\n")
            f.write(qual[i].tobytes() + b"\n")
    return codes


def read_lines_file(path):
    with open(path, "rb") as f:
        lines = f.read().splitlines()
    return np.stack([dna.SYM2VAL[np.frombuffer(l, dtype=np.uint8)] for l in lines])


def _multiset_eq(a, b):
    return decoder._multiset_equal(a, b)


@pytest.fixture(scope="module")
def se_input(tmp_path_factory):
    d = tmp_path_factory.mktemp("se")
    path = str(d / "in.fastq")
    codes = synth_fastq(path, 800, 80, 4000, seed=10)
    return path, codes, str(d)


def test_se_roundtrip(se_input):
    path, codes, d = se_input
    params = PgRCParams(src_fastq=path, output=d + "/a.pgtc")
    stats = encoder.encode(params)
    assert stats.reads_total == 800
    n = decoder.decode_to_files(d + "/a.pgtc", d + "/a")
    assert n == 800
    got = read_lines_file(d + "/a_out")
    assert _multiset_eq(got, codes)
    # archive should beat 2-bit packing on genome-derived reads
    assert stats.archive_bytes < 800 * 80 / 4 * 1.5


def test_se_ord_roundtrip(se_input):
    path, codes, d = se_input
    params = PgRCParams(src_fastq=path, output=d + "/o.pgtc", preserve_order=True)
    encoder.encode(params)
    decoder.decode_to_files(d + "/o.pgtc", d + "/o")
    got = read_lines_file(d + "/o_out")
    np.testing.assert_array_equal(got, codes)  # byte-identical


def test_se_validation_mode(se_input):
    path, codes, d = se_input
    params = PgRCParams(src_fastq=path, output=d + "/v.pgtc")
    encoder.encode(params)
    rep = decoder.validate(d + "/v.pgtc", path)
    assert rep["errors"] == 0


def test_validation_detects_wrong_source(se_input, tmp_path):
    """The streaming validator must FAIL against a different source file
    (one altered read), in both multiset and order-exact modes."""
    path, codes, d = se_input
    d = str(tmp_path)
    encoder.encode(PgRCParams(src_fastq=path, output=d + "/v.pgtc"))
    # build an altered copy: flip one base of one read's sequence line
    altered = str(tmp_path / "alt.fastq")
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    seq = bytearray(lines[1])
    seq[3] = ord(b"A") if seq[3] != ord(b"A") else ord(b"C")
    lines[1] = bytes(seq)
    with open(altered, "wb") as f:
        f.write(b"\n".join(lines))
    rep = decoder.validate(d + "/v.pgtc", altered)
    assert rep["errors"] > 0
    ord_out = d + "/v_ord.pgtc"
    encoder.encode(PgRCParams(src_fastq=path, output=ord_out,
                              preserve_order=True))
    assert decoder.validate(ord_out, path)["errors"] == 0
    rep = decoder.validate(ord_out, altered)
    assert rep["errors"] > 0


@pytest.fixture(scope="module")
def pe_input(tmp_path_factory):
    d = tmp_path_factory.mktemp("pe")
    p1 = str(d / "in1.fastq")
    p2 = str(d / "in2.fastq")
    c1 = synth_fastq(p1, 400, 80, 4000, seed=20)
    c2 = synth_fastq(p2, 400, 80, 4000, seed=21)
    return p1, p2, c1, c2, str(d)


def test_pe_roundtrip(pe_input):
    p1, p2, c1, c2, d = pe_input
    params = PgRCParams(src_fastq=p1, pair_fastq=p2, output=d + "/p.pgtc")
    stats = encoder.encode(params)
    assert stats.reads_total == 800
    decoder.decode_to_files(d + "/p.pgtc", d + "/p")
    g1 = read_lines_file(d + "/p_out_1")
    g2 = read_lines_file(d + "/p_out_2")
    # pair association preserved: multiset of concatenated pairs equal
    got_pairs = np.concatenate([g1, g2], axis=1)
    want_pairs = np.concatenate([c1, c2], axis=1)
    assert _multiset_eq(got_pairs, want_pairs)


def test_pe_ord_roundtrip(pe_input):
    p1, p2, c1, c2, d = pe_input
    params = PgRCParams(
        src_fastq=p1, pair_fastq=p2, output=d + "/q.pgtc", preserve_order=True
    )
    encoder.encode(params)
    decoder.decode_to_files(d + "/q.pgtc", d + "/q")
    np.testing.assert_array_equal(read_lines_file(d + "/q_out_1"), c1)
    np.testing.assert_array_equal(read_lines_file(d + "/q_out_2"), c2)


def test_pe_min_roundtrip(pe_input):
    p1, p2, c1, c2, d = pe_input
    params = PgRCParams(
        src_fastq=p1, pair_fastq=p2, output=d + "/m.pgtc", ignore_pair_order=True
    )
    encoder.encode(params)
    decoder.decode_to_files(d + "/m.pgtc", d + "/m")
    g1 = read_lines_file(d + "/m_out_1")
    g2 = read_lines_file(d + "/m_out_2")
    all_got = np.concatenate([g1, g2], axis=0)
    all_want = np.concatenate([c1, c2], axis=0)
    assert _multiset_eq(all_got, all_want)


def test_n_reads_are_matched(tmp_path):
    """Reads containing N should still map onto the HQ pg (N counts as a
    mismatch via the exact re-verify), not fall through to the N pg."""
    rng = np.random.default_rng(33)
    genome = rng.integers(0, 4, size=4000, dtype=np.uint8)
    n_reads, L = 600, 80
    starts = rng.integers(0, 4000 - L, size=n_reads)
    codes = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    n_rows = np.arange(0, n_reads, 10)       # 10% of reads get one N
    codes[n_rows, 5] = dna.N
    qual = np.full((n_reads, L), ord("I"), dtype=np.uint8)
    qual[n_rows, L // 2:] = ord("#")         # N rows are low quality too
    path = str(tmp_path / "n.fastq")
    with open(path, "wb") as f:
        for i in range(n_reads):
            f.write(b"@r%d\n" % i)
            f.write(dna.VAL2SYM[codes[i]].tobytes() + b"\n+\n")
            f.write(qual[i].tobytes() + b"\n")
    params = PgRCParams(src_fastq=path, output=str(tmp_path / "n.pgtc"))
    stats = encoder.encode(params)
    # most N reads should have matched (1 N mismatch out of budget 26)
    assert stats.matched_count >= n_rows.size * 0.8
    rep = decoder.validate(str(tmp_path / "n.pgtc"), path)
    assert rep["errors"] == 0


def test_pe_validation_mode(pe_input):
    p1, p2, c1, c2, d = pe_input
    params = PgRCParams(src_fastq=p1, pair_fastq=p2, output=d + "/pv.pgtc")
    encoder.encode(params)
    rep = decoder.validate(d + "/pv.pgtc", p1, p2)
    assert rep["errors"] == 0


def test_stage_bisection_identical_archive(se_input):
    """Running the chain in -E/-B halves must produce the same archive as one
    shot (reference stage system, pgrc-params.h:299-317)."""
    path, codes, d = se_input
    full = PgRCParams(src_fastq=path, output=d + "/bis_full.pgtc")
    encoder.encode(full)
    for cut in (2, 4, 5):
        first = PgRCParams(src_fastq=path, output=d + "/bis.pgtc", end_stage=cut)
        encoder.encode(first)
        second = PgRCParams(src_fastq=path, output=d + "/bis.pgtc", begin_stage=cut + 1)
        encoder.encode(second)
        with open(d + "/bis_full.pgtc", "rb") as f1, open(d + "/bis.pgtc", "rb") as f2:
            assert f1.read() == f2.read(), f"cut after stage {cut} diverged"


def test_chunked_decode_equivalence(tmp_path):
    """iter_decoded_chunks with tiny chunks must reproduce the whole-matrix
    decode in every mode (the streaming decode path is the production
    writer; decode_to_matrices is defined over it, so force multi-chunk)."""
    import numpy as np
    from pgrc.archive import decoder, encoder
    from pgrc.config import PgRCParams

    p1 = str(tmp_path / "c1.fastq")
    p2 = str(tmp_path / "c2.fastq")
    synth_fastq(p1, 400, 80, 4000, seed=31)
    synth_fastq(p2, 400, 80, 4000, seed=32)
    for name, kw in (
        ("se", {}),
        ("se_ord", {"preserve_order": True}),
        ("pe", {"pair_fastq": p2}),
        ("pe_ord", {"pair_fastq": p2, "preserve_order": True}),
    ):
        out = str(tmp_path / f"{name}.pgtc")
        encoder.encode(PgRCParams(src_fastq=p1, output=out, **kw))
        ar = decoder.load(out)
        whole = decoder.decode_to_matrices(ar)
        n_files = len(whole)
        parts = [[] for _ in range(n_files)]
        for fi, mat in decoder.iter_decoded_chunks(ar, chunk=64):
            parts[fi].append(mat)
        for fi in range(n_files):
            got = np.concatenate(parts[fi])
            assert np.array_equal(got, whole[fi]), name


def test_plain_offset_representation(tmp_path):
    """-A (plain mismatch offsets, no rev-offset coding) must round-trip;
    the representation flag byte drives the decoder."""
    from pgrc.archive import decoder, encoder
    from pgrc.config import PgRCParams

    src = str(tmp_path / "a.fastq")
    synth_fastq(src, 500, 80, 3000, seed=44)
    out = str(tmp_path / "a.pgtc")
    encoder.encode(PgRCParams(src_fastq=src, output=out,
                              rev_offset_mismatches=False))
    rep = decoder.validate(out, src)
    assert rep["errors"] == 0


def test_analyzer(tmp_path):
    from pgrc.core.analyzer import analyze_reads_set

    src = str(tmp_path / "b.fastq")
    synth_fastq(src, 200, 60, 2000, seed=45)
    props = analyze_reads_set(src)
    assert props.count == 200
    assert props.constant_len and props.all_reads_length == 60
    assert props.total_bases == 12000
    assert props.has_quality
    assert set(props.symbols) <= set("ACGTN")
