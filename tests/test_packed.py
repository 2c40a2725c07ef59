import numpy as np
import pytest

from pgrc.core import packed
from pgrc.utils import dna


def rand_codes(n, length, nsym=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, nsym, size=(n, length), dtype=np.uint8)


def test_pack_unpack_roundtrip():
    for length in (1, 15, 16, 17, 100, 255):
        codes = rand_codes(13, length, seed=length)
        lanes = packed.pack_2bit(codes)
        assert lanes.shape == (13, packed.num_lanes(length))
        back = packed.unpack_2bit(lanes, length)
        np.testing.assert_array_equal(back, codes)


def test_pack_lexicographic_order():
    codes = rand_codes(200, 23, seed=3)
    lanes = packed.pack_2bit(codes)
    # lane-tuple order == string order
    order_str = np.lexsort(codes[:, ::-1].T)
    order_lane = np.lexsort(lanes[:, ::-1].T)
    np.testing.assert_array_equal(order_str, order_lane)


def test_mismatch_count_packed():
    a = rand_codes(50, 100, seed=1)
    b = a.copy()
    rng = np.random.default_rng(2)
    expected = np.zeros(50, dtype=np.int32)
    for i in range(50):
        k = rng.integers(0, 8)
        pos = rng.choice(100, size=k, replace=False)
        for p in pos:
            b[i, p] = (b[i, p] + rng.integers(1, 4)) % 4
        expected[i] = (a[i] != b[i]).sum()
    got = packed.mismatch_count_packed(packed.pack_2bit(a), packed.pack_2bit(b))
    np.testing.assert_array_equal(got, expected)


def test_popcount():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32)
    expected = np.array([bin(int(v)).count("1") for v in x], dtype=np.int32)
    np.testing.assert_array_equal(packed.popcount_u32(x), expected)


def test_revcomp_matrix_matches_scalar():
    codes = rand_codes(20, 31, nsym=5, seed=9)
    got = packed.revcomp_codes_matrix(codes)
    expected = dna.revcomp_codes(codes, axis=1)
    np.testing.assert_array_equal(got, expected)


def test_pack_device_matches_numpy():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    codes = rand_codes(17, 100, seed=5)
    lanes_np = packed.pack_2bit(codes)
    lanes_j = packed.pack_2bit(jnp.asarray(codes))
    np.testing.assert_array_equal(np.asarray(lanes_j), lanes_np)
    mc_np = packed.mismatch_count_packed(lanes_np, lanes_np[::-1].copy())
    mc_j = packed.mismatch_count_packed(lanes_j, jnp.asarray(lanes_np[::-1]))
    np.testing.assert_array_equal(np.asarray(mc_j), mc_np)
