"""Packed-DNA tensor ops (device-first, numpy-compatible).

Replaces the reference's SymbolsPackingFacility + PackedConstantLengthReadsSet
(coders/SymbolsPackingFacility.cpp, readsset/PackedConstantLengthReadsSet.cpp)
with tensor transforms:

- reads live as uint8 value-code matrices [N, L] (values 0..4, see utils.dna)
- hot kernels use a 2-bit lane packing [N, W] uint32 (16 symbols per lane,
  earlier symbols in higher bits so lane tuples compare lexicographically)
- mismatch counting is XOR + 2-bit-group popcount on the packed lanes
  (the device equivalent of CopMEMMatcher.cpp:528-535's 64-bit XOR/popcount)

All functions take/return either numpy or jax arrays (jnp ops via the array
namespace), so the same code paths are unit-testable on CPU.
"""
from __future__ import annotations

import numpy as np

SYMS_PER_LANE = 16  # 2 bits/symbol in a uint32 lane


def _xp(a):
    """Array-namespace dispatch (numpy vs jax.numpy)."""
    if isinstance(a, np.ndarray):
        return np
    import jax.numpy as jnp

    return jnp


def num_lanes(read_len: int) -> int:
    return (read_len + SYMS_PER_LANE - 1) // SYMS_PER_LANE


def pack_2bit(codes, read_len: int | None = None):
    """[N, L] uint8 codes (ACGT only; N must be pre-mapped) -> [N, W] uint32.

    Symbol j sits in lane j//16 at bit position 2*(15 - j%16); tail symbols of
    the last lane are zero-padded, so lane-tuple comparison == lexicographic
    string comparison.
    """
    xp = _xp(codes)
    n, length = codes.shape
    if read_len is None:
        read_len = length
    w = num_lanes(read_len)
    pad = w * SYMS_PER_LANE - length
    if pad:
        codes = xp.concatenate([codes, xp.zeros((n, pad), dtype=codes.dtype)], axis=1)
    c = (codes & 0x3).astype(xp.uint32).reshape(n, w, SYMS_PER_LANE)
    shifts = xp.arange(SYMS_PER_LANE - 1, -1, -1, dtype=xp.uint32) * xp.uint32(2)
    return (c << shifts).sum(axis=2).astype(xp.uint32)


def unpack_2bit(lanes, read_len: int):
    """[N, W] uint32 -> [N, L] uint8 codes (values 0..3)."""
    xp = _xp(lanes)
    n, w = lanes.shape
    shifts = xp.arange(SYMS_PER_LANE - 1, -1, -1, dtype=xp.uint32) * xp.uint32(2)
    c = (lanes[:, :, None] >> shifts) & xp.uint32(0x3)
    return c.reshape(n, w * SYMS_PER_LANE)[:, :read_len].astype(xp.uint8)


def mismatch_count_packed(a, b):
    """Per-row count of differing 2-bit groups between packed lane matrices.

    a, b: [..., W] uint32. Returns [...] int32.
    """
    xp = _xp(a)
    x = a ^ b
    y = (x | (x >> xp.uint32(1))) & xp.uint32(0x55555555)
    return popcount_u32(y).sum(axis=-1).astype(xp.int32)


def popcount_u32(x):
    """Bit population count of uint32 (SWAR; works in numpy and jnp)."""
    xp = _xp(x)
    x = x - ((x >> xp.uint32(1)) & xp.uint32(0x55555555))
    x = (x & xp.uint32(0x33333333)) + ((x >> xp.uint32(2)) & xp.uint32(0x33333333))
    x = (x + (x >> xp.uint32(4))) & xp.uint32(0x0F0F0F0F)
    return ((x * xp.uint32(0x01010101)) >> xp.uint32(24)).astype(xp.int32)


SYMS_PER_LANE64 = 32  # 2 bits/symbol in a uint64 lane


def num_lanes64(read_len: int) -> int:
    return (read_len + SYMS_PER_LANE64 - 1) // SYMS_PER_LANE64


def widen_lanes_u64(lanes_u32):
    """[..., W] uint32 lanes -> [..., ceil(W/2)] uint64 lanes (same symbol
    order: earlier symbols in higher bits). Halves the element count of
    gather-heavy verify kernels."""
    xp = _xp(lanes_u32)
    w = lanes_u32.shape[-1]
    if w % 2:
        pad_shape = lanes_u32.shape[:-1] + (1,)
        lanes_u32 = xp.concatenate(
            [lanes_u32, xp.zeros(pad_shape, dtype=lanes_u32.dtype)], axis=-1
        )
        w += 1
    hi = lanes_u32[..., 0::2].astype(xp.uint64)
    lo = lanes_u32[..., 1::2].astype(xp.uint64)
    return (hi << xp.uint64(32)) | lo


def popcount_u64(x):
    """Bit population count of uint64 (SWAR; works in numpy and jnp)."""
    xp = _xp(x)
    x = x - ((x >> xp.uint64(1)) & xp.uint64(0x5555555555555555))
    x = (x & xp.uint64(0x3333333333333333)) + (
        (x >> xp.uint64(2)) & xp.uint64(0x3333333333333333)
    )
    x = (x + (x >> xp.uint64(4))) & xp.uint64(0x0F0F0F0F0F0F0F0F)
    return ((x * xp.uint64(0x0101010101010101)) >> xp.uint64(56)).astype(xp.int32)


def pack_text_2bit(codes_1d):
    """1-D sequence codes -> uint32 lanes, 16 symbols/lane, zero-padded.

    Layout matches pack_2bit rows; used for the pseudogenome text so read
    windows can be verified against it lane-wise (see align/).
    """
    xp = _xp(codes_1d)
    n = codes_1d.shape[0]
    w = num_lanes(n)
    pad = w * SYMS_PER_LANE - n
    if pad:
        codes_1d = xp.concatenate([codes_1d, xp.zeros((pad,), dtype=codes_1d.dtype)])
    c = (codes_1d & 0x3).astype(xp.uint32).reshape(w, SYMS_PER_LANE)
    shifts = xp.arange(SYMS_PER_LANE - 1, -1, -1, dtype=xp.uint32) * xp.uint32(2)
    return (c << shifts).sum(axis=1).astype(xp.uint32)


def pack_lanes(codes: np.ndarray, n_pad: int | None = None):
    """Host-side packing of an ACGTN code matrix for the packed overlap/match
    kernels: returns (lanes [n_pad, W+1] uint32, nmask [n_pad, Wn+1] uint32
    or None). lanes hold 2-bit symbols (N packed as A) with one zero pad
    lane for cross-lane shifts; nmask holds N-position bits (bit 31-j%32 of
    lane j//32) and is None when the matrix has no N. Rows past n are zero.

    Native C++ fast path (native/packcodes.cpp); numpy fallback below.
    """
    n, L = codes.shape
    if n_pad is None:
        n_pad = n
    W = (L + 15) // 16
    Wn = (L + 31) // 32
    has_n = bool((codes > 3).any())
    from .. import native

    lanes = np.zeros((n_pad, W + 1), dtype=np.uint32)
    nmask = np.zeros((n_pad, Wn + 1), dtype=np.uint32) if has_n else None
    packed_ok = native.pack_lanes(codes, lanes[:n], nmask[:n] if has_n else None)
    if not packed_ok:
        pad = W * SYMS_PER_LANE - L
        c = codes & 0x3
        if pad:
            c = np.concatenate([c, np.zeros((n, pad), dtype=np.uint8)], axis=1)
        shifts = np.arange(SYMS_PER_LANE - 1, -1, -1, dtype=np.uint32) * np.uint32(2)
        lanes[:n, :W] = (
            c.astype(np.uint32).reshape(n, W, SYMS_PER_LANE) << shifts
        ).sum(axis=2, dtype=np.uint32)
        if has_n:
            padn = Wn * 32 - L
            nb = (codes > 3).astype(np.uint32)
            if padn:
                nb = np.concatenate([nb, np.zeros((n, padn), dtype=np.uint32)], axis=1)
            shifts_n = np.arange(31, -1, -1, dtype=np.uint32)
            nmask[:n, :Wn] = (nb.reshape(n, Wn, 32) << shifts_n).sum(axis=2, dtype=np.uint32)
    return lanes, nmask


def _swap_groups_u32(xp, v, width):
    """Reverse the order of `width`-bit groups within each uint32."""
    if width <= 16:
        v = ((v & xp.uint32(0x0000FFFF)) << xp.uint32(16)) | (v >> xp.uint32(16))
    if width <= 8:
        v = ((v & xp.uint32(0x00FF00FF)) << xp.uint32(8)) | \
            ((v >> xp.uint32(8)) & xp.uint32(0x00FF00FF))
    if width <= 4:
        v = ((v & xp.uint32(0x0F0F0F0F)) << xp.uint32(4)) | \
            ((v >> xp.uint32(4)) & xp.uint32(0x0F0F0F0F))
    if width <= 2:
        v = ((v & xp.uint32(0x33333333)) << xp.uint32(2)) | \
            ((v >> xp.uint32(2)) & xp.uint32(0x33333333))
    if width <= 1:
        v = ((v & xp.uint32(0x55555555)) << xp.uint32(1)) | \
            ((v >> xp.uint32(1)) & xp.uint32(0x55555555))
    return v


def _shift_left_lanes(xp, v, bits):
    """Shift a [n, W] lane matrix left by `bits` across lane boundaries
    (bits < 32); vacated low bits fill with zeros."""
    if bits == 0:
        return v
    n = v.shape[0]
    nxt = xp.concatenate([v[:, 1:], xp.zeros((n, 1), dtype=v.dtype)], axis=1)
    return (v << xp.uint32(bits)) | (nxt >> xp.uint32(32 - bits))


def revcomp_lanes(lanes, read_len: int, nmask=None):
    """Reverse-complement packed 2-bit lane rows (device-friendly).

    `lanes`: [n, W+1] uint32 in pack_lanes layout (symbol j at bits
    2*(15 - j%16) of lane j//16, one zero pad lane). Returns the RC rows in
    the same layout — bit-identical to pack_lanes(revcomp_codes_matrix(c))
    for ACGT rows. With `nmask` ([n, Wn+1] uint32 N-position bits), the
    groups landing on (reversed) N positions are cleared to A, matching
    the matcher's convention that N probes as A on both strands.

    Runs on numpy or jax arrays; on device it replaces a second host
    pack + upload of the RC strand.
    """
    xp = _xp(lanes)
    L = read_len
    W = num_lanes(L)
    body = lanes[:, :W]
    # complement (v -> 3-v == bitwise NOT per 2-bit group), reverse lanes,
    # reverse 2-bit groups within each lane
    v = _swap_groups_u32(xp, (~body)[:, ::-1], 2)
    # the reversed read occupies the LAST L of the W*16 symbol slots
    pad_syms = W * SYMS_PER_LANE - L
    v = _shift_left_lanes(xp, v, 2 * pad_syms)
    # zero the tail slots (they held complemented padding)
    tail = L - (W - 1) * SYMS_PER_LANE
    lane_mask = np.full(W, 0xFFFFFFFF, dtype=np.uint32)
    if tail < SYMS_PER_LANE:
        lane_mask[W - 1] = np.uint32((0xFFFFFFFF << (32 - 2 * tail)) & 0xFFFFFFFF)
    v = v & xp.asarray(lane_mask)[None, :]
    if nmask is not None:
        Wn = (L + 31) // 32
        nb = _swap_groups_u32(xp, nmask[:, :Wn][:, ::-1], 1)
        nb = _shift_left_lanes(xp, nb, Wn * 32 - L)
        # expand each N bit to a 2-bit clear mask over the two code lanes
        # covered by one nmask lane (bits 31..16 -> even lane, 15..0 -> odd)
        def spread16(x):
            x = (x | (x << xp.uint32(8))) & xp.uint32(0x00FF00FF)
            x = (x | (x << xp.uint32(4))) & xp.uint32(0x0F0F0F0F)
            x = (x | (x << xp.uint32(2))) & xp.uint32(0x33333333)
            x = (x | (x << xp.uint32(1))) & xp.uint32(0x55555555)
            return x | (x << xp.uint32(1))

        hi = spread16(nb >> xp.uint32(16))
        lo = spread16(nb & xp.uint32(0xFFFF))
        clear = xp.stack([hi, lo], axis=2).reshape(nb.shape[0], 2 * Wn)[:, :W]
        v = v & ~clear
    n = lanes.shape[0]
    return xp.concatenate([v, xp.zeros((n, 1), dtype=lanes.dtype)], axis=1)


def revcomp_codes_matrix(codes):
    """Reverse complement rows of an ACGTN code matrix (vector form of
    utils/helper.cpp:388-397)."""
    xp = _xp(codes)
    flipped = codes[:, ::-1]
    return xp.where(flipped <= 3, 3 - flipped, flipped).astype(codes.dtype)
