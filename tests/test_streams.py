import io

import numpy as np
import pytest

from pgrc.streams import codecs, container, rangecoder, varlen_dna
from pgrc.streams.codecs import Codec
from pgrc.streams.container import CompressionJob, StreamReader
from pgrc.utils import varint


def test_varint_scalar_roundtrip():
    buf = bytearray()
    vals = [0, 1, 127, 128, 300, 2**21, 2**35, 2**63]
    for v in vals:
        varint.write_varint(buf, v)
    pos = 0
    for v in vals:
        got, pos = varint.read_varint(bytes(buf), pos)
        assert got == v


def test_varint_batch_roundtrip():
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 2**40, size=1000, dtype=np.uint64)
    vals[:10] = [0, 1, 127, 128, 129, 16383, 16384, 2**30, 2**39, 7]
    enc = varint.encode_varints(vals)
    dec = varint.decode_varints(enc, len(vals))
    np.testing.assert_array_equal(dec, vals)
    assert varint.varints_span(enc, len(vals)) == len(enc)
    # scalar-compatible
    got, pos = varint.read_varint(enc, 0)
    assert got == int(vals[0])


@pytest.mark.parametrize("order,period", [(0, 1), (0, 4), (1, 1), (1, 2)])
def test_rangecoder_roundtrip(order, period):
    rng = np.random.default_rng(1)
    data = rng.integers(0, 8, size=2000, dtype=np.uint8)  # skewed small alphabet
    enc = rangecoder.encode(data, order=order, period=period)
    dec = rangecoder.decode(enc, len(data), order=order, period=period)
    np.testing.assert_array_equal(dec, data)


def test_rangecoder_compresses_skewed():
    rng = np.random.default_rng(2)
    data = rng.choice([0, 1], p=[0.95, 0.05], size=5000).astype(np.uint8)
    enc = rangecoder.encode(data, order=0)
    assert len(enc) < 1000  # ~0.29 bits/sym ideal; generous bound


def test_varlen_dna_roundtrip():
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 3, 4, 5, 100, 10001):
        data = rng.choice(
            np.arange(6, dtype=np.uint8), p=[0.24, 0.24, 0.24, 0.24, 0.02, 0.02], size=n
        ).tobytes()
        enc = varlen_dna.encode(data)
        dec = varlen_dna.decode(enc, n)
        assert dec == data
        if n >= 100:
            assert len(enc) < 0.45 * n  # better than 1 byte per ~2.2 symbols


def test_codec_roundtrip_all():
    rng = np.random.default_rng(4)
    data = rng.integers(0, 5, size=3000, dtype=np.uint8).tobytes()
    for codec in [
        Codec(codecs.STORE),
        Codec(codecs.ZLIB),
        Codec(codecs.LZMA_CODER, codecs.LEVEL_NORMAL, 1),
        Codec(codecs.LZMA_CODER, codecs.LEVEL_NORMAL, 4),
        Codec(codecs.RANS),
        Codec(codecs.RANGE_O0),
        Codec(codecs.RANGE_O1),
        Codec(codecs.VARLEN_DNA, 0),
    ]:
        enc = codec.compress(data)
        dec = codec.decompress(enc, len(data))
        assert dec == data, f"codec {codec.key()} failed"


def test_container_roundtrip():
    rng = np.random.default_rng(5)
    streams = [
        rng.integers(0, 4, size=1000, dtype=np.uint8).tobytes(),
        b"",
        rng.integers(0, 256, size=500, dtype=np.uint8).tobytes(),  # incompressible
        b"A" * 10000,
    ]
    jobs = [
        CompressionJob("a", streams[0], Codec(codecs.LZMA_CODER, 2, 1)),
        CompressionJob("b", streams[1], Codec(codecs.RANS)),
        CompressionJob("c", streams[2], Codec(codecs.LZMA_CODER, 2, 1)),
        CompressionJob("d", streams[3], Codec(codecs.RANS), alternatives=[Codec(codecs.ZLIB)]),
    ]
    out = io.BytesIO()
    sizes = container.write_streams(out, jobs)
    assert len(sizes) == 4
    reader = StreamReader(out.getvalue())
    for s in streams:
        assert reader.read_one() == s
    # batch read
    reader2 = StreamReader(out.getvalue())
    got = reader2.read_many(4)
    assert got == streams


def test_native_rangecoder_bitcompat():
    """Native C++ coder must be bit-compatible with the pure-Python reference."""
    from pgrc import native
    from pgrc.streams import rangecoder as rc

    if native.get_lib() is None:
        import pytest

        pytest.skip("no native toolchain")
    rng = np.random.default_rng(5)
    for order, period, nsym in [(0, 1, 256), (0, 2, 256), (1, 1, 8), (1, 3, 64)]:
        data = rng.integers(0, nsym, size=5000, dtype=np.uint8)
        # skew the distribution so compression actually engages
        data[data % 3 == 0] = 1
        enc_native = native.rc_encode(data.tobytes(), order, period, nsym)
        dec = rc.decode(enc_native, data.size, order, period, nsym)
        np.testing.assert_array_equal(dec, data)
        # python decode of native bytes (cross-check both directions)
        dec_py = rc._py_decode(enc_native, data.size, order, period, nsym)
        np.testing.assert_array_equal(dec_py, data)
        enc_py2 = rc._py_encode(data, order, period, nsym)
        assert enc_py2 == enc_native


def test_blocked_codec_roundtrip():
    import numpy as np

    from pgrc.streams.codecs import BLOCKED, RANS, LZMA_CODER, Codec, BLOCK_SIZE

    rng = np.random.default_rng(3)
    data = rng.integers(0, 4, size=BLOCK_SIZE * 2 + 12345, dtype=np.uint8).tobytes()
    for inner, p in ((RANS, 0), (LZMA_CODER, 1)):
        c = Codec(BLOCKED, inner, p)
        comp = c.compress(data)
        assert c.decompress(comp, len(data)) == data


def test_blocked_codec_small_and_empty():
    from pgrc.streams.codecs import BLOCKED, LZMA_CODER, RANS, Codec

    for c in (Codec(BLOCKED, RANS, 0), Codec(BLOCKED, LZMA_CODER, 1)):
        for data in (b"", b"x", b"hello" * 100):
            assert c.decompress(c.compress(data), len(data)) == data


def test_pe_ord_positions_wide_roundtrip():
    """>4 GB joined-pg positions must survive the PE_ORD codec (no silent
    u32 truncation) — codec-level test, no giant allocation."""
    import io

    import numpy as np

    from pgrc.archive import order as order_enc
    from pgrc.streams.container import StreamReader

    rng = np.random.default_rng(5)
    n_pairs = 500
    base = rng.integers(0, 1 << 36, n_pairs).astype(np.int64)
    mate = base + rng.integers(-70000, 70000, n_pairs)
    mate = np.clip(mate, 0, None)
    pos = np.empty(n_pairs * 2, dtype=np.int64)
    pos[0::2] = base
    pos[1::2] = mate
    buf = io.BytesIO()
    order_enc.encode_positions_pe(buf, pos)
    back = order_enc.decode_positions_pe(StreamReader(buf.getvalue()), pos.size)
    assert np.array_equal(back, pos)


def test_pe_ord_positions_narrow_roundtrip():
    import io

    import numpy as np

    from pgrc.archive import order as order_enc
    from pgrc.streams.container import StreamReader

    rng = np.random.default_rng(6)
    pos = rng.integers(0, 1 << 30, 1000).astype(np.int64)
    buf = io.BytesIO()
    order_enc.encode_positions_pe(buf, pos)
    back = order_enc.decode_positions_pe(StreamReader(buf.getvalue()), pos.size)
    assert np.array_equal(back, pos)


def test_rans_roundtrip_and_native_python_compat():
    """Own static rANS coder (FSE role): round-trips on varied
    distributions, and the native C++ and pure-Python implementations
    produce IDENTICAL streams (archives must not depend on a compiler)."""
    import numpy as np
    from pgrc import native
    from pgrc.streams import codecs, rans_py

    rng = np.random.default_rng(3)
    cases = [
        b"",
        b"A",
        b"A" * 10000,                                   # single symbol
        bytes(rng.integers(0, 256, size=50000, dtype=np.uint8)),  # uniform
        bytes(rng.choice([0, 1, 2, 3], p=[0.7, 0.2, 0.08, 0.02],
                         size=100000).astype(np.uint8)),  # skewed DNA-ish
        bytes(rng.integers(0, 4, size=257, dtype=np.uint8)),
    ]
    for data in cases:
        py = rans_py.encode(data)
        assert rans_py.decode(py, len(data)) == data
        nat = native.rans_encode(data)
        if nat is not None:
            assert nat == py, "native and python rANS streams differ"
            assert native.rans_decode(py, len(data)) == data
        # through the codec layer
        c = codecs.Codec(codecs.RANS)
        out = c.compress(data)
        assert c.decompress(out, len(data)) == data
    # entropy sanity: the skewed stream must actually compress
    skew = cases[4]
    assert len(codecs.Codec(codecs.RANS).compress(skew)) < 0.3 * len(skew)


def test_rans_malformed_fails_cleanly():
    import pytest as _pytest

    from pgrc.streams import rans_py

    with _pytest.raises(ValueError):
        rans_py.decode(b"\xff\xff" + b"\x00" * 10, 5)
    ok = rans_py.encode(b"hello world" * 100)
    with _pytest.raises(ValueError):
        rans_py.decode(ok[: len(ok) // 2], 1100)
