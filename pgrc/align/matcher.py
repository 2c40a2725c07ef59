"""Read -> pseudogenome approximate matcher (device copMEM equivalent).

Replaces CopMEMMatcher + CopMEMReadsApproxMatcher (matching/copmem/
CopMEMMatcher.cpp:139-324 index build, :483-566 probe+verify loop;
matching/ReadsMatchers.cpp:421-451 OMP read loop) with:

  * a SORTED sampled k-mer index over the pg (positions every k1, full
    32-bit rolling polynomial hash), built vectorized on the host;
  * a statically-shaped SORT-MERGE probe program (v2): reads live as
    packed 2-bit u32 lanes; probe anchor hashes are computed ON DEVICE
    from the lanes, then index entries and probe entries are kv-sorted
    together by hash — each probe's candidate (the minimum-position index
    entry with an EXACTLY equal 32-bit hash) comes from a segmented
    cummax carry, and results route back to read-major order with one
    more sort. The merge-join replaces every CSR bucket gather of the v1
    design, on the assumption that a multi-operand sort is cheaper than
    the same number of random gathers (unmeasured on the H100);
  * only CONFIRMED candidates are verified (cross-lane-shift XOR +
    popcount against the packed pg), on rows aligned with the read-lane
    matrix so the read side needs no gather at all;
  * forward-first two-phase probing (the reference's fwd pass then
    RC-improve-only, ReadsMatchers.cpp:162-184): pass 1 probes every read
    forward at k1 residue-covering spread offsets and verifies the first
    confirmed anchor; only the leftovers probe both strands at the full
    fan-out with a multi-candidate verify. RC wins only with strictly
    fewer mismatches;
  * a deterministic (mismatches, then position) two-step min reduction
    replaces the reference's benign OMP race on best-match updates.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import packed
from ..device import jax_modules as _jax
from ..overlap.greedy_scs import HASH_BASE, HASH_BASE_INV

DEFAULT_K = 32
DEFAULT_K1 = 4          # pg sampling stride
DEFAULT_K2 = 3          # read probe stride (coprime with k1; reference k2 table)
DEFAULT_CAP = 8         # candidates kept per bucket probe
NOT_MATCHED = np.uint8(255)


@dataclass
class KmerIndex:
    hash_sorted: np.ndarray  # [P] uint32 full k-mer hashes (ascending when
    pos_sorted: np.ndarray   # `sorted`); [P] int64 pg position per entry.
    # Both are None for a LAZY index (device_sort=True): the probe builds
    # the (hash, pos) table ON DEVICE from the packed pg upload — 16x fewer
    # bytes host->device than uploading the host-built table.
    k: int
    k1: int
    pg_len: int
    # False = entries unsorted (sampling order). The sort-merge probe does
    # NOT need a sorted index (its min-position carry is order-independent);
    # only host consumers doing searchsorted equal-range lookups
    # (archive/pg_match.py) need sorted=True.
    sorted: bool = True

    @property
    def n_entries(self) -> int:
        if self.pos_sorted is not None:
            return self.pos_sorted.size
        nw = self.pg_len - self.k + 1  # sampled at stride k1
        return 0 if nw <= 0 else -(-nw // self.k1)

    @property
    def positions(self) -> np.ndarray:  # back-compat introspection
        if self.pos_sorted is None:
            return np.arange(0, max(self.pg_len - self.k + 1, 0), self.k1,
                             dtype=np.int64)
        return self.pos_sorted


_HASH_BLOCK = 1 << 23


def _window_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    """Rolling polynomial hash of every k-window of a 1-D code array:
    H(i) = sum codes[i+t] * B^(k-1-t) mod 2^32, computed via prefix sums of
    codes[j] * B^(-j). Processed in blocks (k-1 overlap) so the transient
    working set stays ~4x the block size instead of ~16 bytes per pg symbol
    (a 54M-symbol pg cost ~0.9 GB of temporaries, twice concurrently with
    the stage-7 worker thread)."""
    n = codes.shape[0]
    if n < k:
        return np.zeros(0, dtype=np.uint32)
    out = np.empty(n - k + 1, dtype=np.uint32)
    step = _HASH_BLOCK
    for lo in range(0, n - k + 1, step):
        hi = min(lo + step + k - 1, n)
        _window_hashes_block(codes[lo:hi], k, out[lo : hi - k + 1])
    return out


def _window_hashes_block(codes: np.ndarray, k: int, out: np.ndarray) -> None:
    n = codes.shape[0]
    # inv_pows[j] = B^-j; uint32 cumprod wraps mod 2^32, which IS the hash ring
    inv_pows = np.full(n, np.uint32(HASH_BASE_INV), dtype=np.uint32)
    inv_pows[0] = 1
    np.cumprod(inv_pows, out=inv_pows)
    s = np.zeros(n + 1, dtype=np.uint32)
    np.cumsum(codes.astype(np.uint32) * inv_pows, out=s[1:], dtype=np.uint32)
    nwin = n - k + 1
    # H(i) = (S[i+k] - S[i]) * B^(i + k - 1): consecutive powers via cumprod
    mult = np.full(nwin, np.uint32(HASH_BASE), dtype=np.uint32)
    mult[0] = np.uint32(pow(int(HASH_BASE), k - 1, 1 << 32))
    np.cumprod(mult, out=mult)
    np.multiply(s[k : k + nwin] - s[:nwin], mult, out=out)


def build_index(
    pg_codes: np.ndarray,
    k: int = DEFAULT_K,
    k1: int = DEFAULT_K1,
    bits: int | None = None,      # accepted for back-compat; unused (v2)
    max_bucket: int | None = None,
    device_sort: bool = False,
) -> KmerIndex:
    """Sampled sorted k-mer index of the pg (host-vectorized build).

    v2: a plain (hash, position) table sorted by hash — the probe is a
    sort-merge join, so no CSR buckets and no bucket truncation (a
    repetitive pg's long equal-hash runs cost the join nothing; the
    reference's collision limits, CopMEMMatcher.h:11-13, existed to bound
    its per-read bucket scans)."""
    n = pg_codes.shape[0]
    if n < k:
        return KmerIndex(hash_sorted=np.zeros(0, dtype=np.uint32),
                         pos_sorted=np.zeros(0, dtype=np.int64),
                         k=k, k1=k1, pg_len=n)
    if device_sort:
        # LAZY: the probe builds the (hash, pos) table on device from the
        # packed pg itself (device_index), so no host hashing at all
        return KmerIndex(hash_sorted=None, pos_sorted=None,
                         k=k, k1=k1, pg_len=n, sorted=False)
    hashes = _window_hashes(pg_codes, k)
    sampled = np.arange(0, n - k + 1, k1, dtype=np.int64)
    hs = hashes[sampled]
    order = np.argsort(hs, kind="stable")  # pos ascending within a run
    return KmerIndex(hash_sorted=hs[order], pos_sorted=sampled[order],
                     k=k, k1=k1, pg_len=n)


_POS_BITS = 35          # pos field width in the carry pack (pg <= 2^35)
_POS_MASK = np.uint64((1 << _POS_BITS) - 1)


def _make_probe(n_reads: int, L: int, probe_offs: tuple, k: int, i_pad: int,
                pg_lanes_len: int, max_mis: int, wide: bool = False,
                n_verify: int = 1):
    """Raw (unjitted) sort-merge probe (v2).

    One program: on-device anchor hashes from packed lanes -> kv-sort of
    (index ++ probe) entries by full 32-bit hash -> segmented cummax carry
    gives every probe its minimum-position EXACT-hash candidate -> one
    route sort back to read-major order -> confirmed-only verify on rows
    aligned with the read-lane matrix. No CSR bucket gathers; the only
    gather left is the pg-window fetch of the verify itself.

    `n_verify` = 1 verifies each read's first confirmed offset (pass 1);
    > 1 verifies the first n_verify confirmed offsets and takes the
    deterministic (mismatches, position) minimum (pass 2).

    Per-read independent, so any row partitioning gives identical results —
    the same body runs jitted single-device and shard_mapped over a mesh.
    `wide` switches positions to i64 for pgs past 2^31 symbols (up to 2^35)
    — the analog of the reference's uint_pg_len_max widening
    (pg-config.h:39-44, CopMEMMatcher.cpp:579-590)."""
    jax, jnp = _jax()
    W = (L + 15) // 16
    S = len(probe_offs)
    P = n_reads * S
    m2 = i_pad + P
    if m2 >= (1 << 29):
        raise NotImplementedError("probe batch exceeds 2^29 join entries")
    pos_t = jnp.int64 if wide else jnp.int32
    big_pos = np.int64(0x7FFFFFFFFFFFFFFF) if wide else np.int32(0x7FFFFFFF)
    probe_off_np = np.asarray(probe_offs, dtype=np.int32)
    U32INV = np.uint32(0xFFFFFFFF)

    # tail mask for the last read lane
    lane_mask = np.full(W, 0xFFFFFFFF, dtype=np.uint32)
    tail = L - (W - 1) * packed.SYMS_PER_LANE
    if tail < packed.SYMS_PER_LANE:
        lane_mask[W - 1] = np.uint32((0xFFFFFFFF << (32 - 2 * tail)) & 0xFFFFFFFF)

    def _verify(read_lanes_b, start_c, pg_lanes):
        """Packed mismatch count of pg windows at start_c [...] against
        read lanes broadcast over the same leading dims."""
        q = (start_c >> 4).astype(jnp.int32)
        s2 = ((start_c & 15) << 1).astype(jnp.uint32)
        lane_ids = q[..., None] + jnp.arange(W + 1, dtype=jnp.int32)
        lane_ids = jnp.clip(lane_ids, 0, pg_lanes_len - 1)
        tl = jnp.take(pg_lanes, lane_ids)            # [..., W+1] u32
        s2e = s2[..., None]
        hi = tl[..., :W] << s2e
        lo_part = jnp.where(s2e > 0, tl[..., 1 : W + 1] >> (jnp.uint32(32) - s2e),
                            jnp.uint32(0))
        aligned = (hi | lo_part) & jnp.asarray(lane_mask)
        x = aligned ^ (read_lanes_b & jnp.asarray(lane_mask))
        y = (x | (x >> jnp.uint32(1))) & jnp.uint32(0x55555555)
        return packed.popcount_u32(y).sum(axis=-1)

    def probe_fn(read_lanes, ihash, ipos, pg_lanes, pg_len):
        # --- on-device probe hashes from packed lanes: per-offset unrolled
        # Horner over lane columns. O([R]) temporaries (the earlier [R, L]
        # cumsum formulation held ~0.5 GB per 2^20 rows, capping batch
        # size and multiplying index re-sorts) ---
        offs = jnp.asarray(probe_off_np)
        cols = [read_lanes[:, c] for c in range(read_lanes.shape[1])]
        hs_list = []
        for o in probe_offs:
            h = jnp.zeros((n_reads,), jnp.uint32)
            for t in range(k):
                c, oo = divmod(o + t, 16)
                vv = (cols[c] >> jnp.uint32(2 * (15 - oo))) & jnp.uint32(3)
                h = h * HASH_BASE + vv
            hs_list.append(h)
        hashes = jnp.stack(hs_list, axis=1)                 # [R, S]

        # --- sort-merge join: index entries sort before the probes of
        # their equal-hash run; a segmented cummax carry hands each probe
        # the minimum-position index entry of its run ---
        kh = jnp.concatenate([ihash, hashes.reshape(P)])
        key2 = jnp.concatenate([
            jnp.where(ipos >= 0, jnp.uint32(0), U32INV),    # pads -> inert
            jnp.arange(1, P + 1, dtype=jnp.uint32),
        ])
        pay = jnp.concatenate([
            jnp.maximum(ipos, 0).astype(jnp.uint64),
            jnp.zeros((P,), jnp.uint64),
        ])
        khs, k2s, pays = jax.lax.sort((kh, key2, pay), num_keys=2,
                                      is_stable=False)
        idx = jnp.arange(m2, dtype=jnp.int32)
        boundary = jnp.concatenate(
            [jnp.ones(1, jnp.bool_), khs[1:] != khs[:-1]])
        seg_start = jax.lax.cummax(jnp.where(boundary, idx, 0))
        is_index = k2s == 0
        # pack (seg_start, inverted pos): the max carries the latest run's
        # minimum position; a probe confirms iff the carried run is its own
        packv = jnp.where(
            is_index,
            (seg_start.astype(jnp.uint64) << jnp.uint64(_POS_BITS))
            | (jnp.uint64(_POS_MASK) - pays),
            jnp.uint64(0))
        carried = jax.lax.cummax(packv)
        cseg = (carried >> jnp.uint64(_POS_BITS)).astype(jnp.int32)
        cpos = (jnp.uint64(_POS_MASK) - (carried & jnp.uint64(_POS_MASK)))
        confirmed = (carried != 0) & (cseg == seg_start)
        is_probe = (k2s >= 1) & (k2s != U32INV)
        # --- route results back to probe-ordinal order (one cheap sort) ---
        route = jnp.where(is_probe, k2s - jnp.uint32(1), U32INV)
        res = jnp.where(is_probe & confirmed, cpos + jnp.uint64(1),
                        jnp.uint64(0))
        _, res_s = jax.lax.sort((route, res), num_keys=1, is_stable=False)
        res_rs = res_s[:P].reshape(n_reads, S)
        has0 = res_rs > 0
        anchor_pos = (res_rs - jnp.uint64(1)).astype(pos_t)
        start_all = anchor_pos - offs[None, :].astype(pos_t)
        in_range = has0 & (start_all >= 0) & (start_all <= pg_len - L)
        pg_top = jnp.maximum(pg_len - L, 0).astype(pos_t)

        if n_verify == 1:
            # verify the first confirmed offset per read, rows aligned
            pick = jnp.argmax(in_range, axis=1)
            has_r = in_range.any(axis=1)
            st = jnp.take_along_axis(start_all, pick[:, None], axis=1)[:, 0]
            st_c = jnp.clip(st, 0, pg_top)
            mis = _verify(read_lanes[:, :W], st_c, pg_lanes)
            mis = jnp.where(has_r, mis, jnp.int32(255))
            ok = mis <= max_mis
            return (jnp.where(ok, mis, 255).astype(jnp.uint8),
                    jnp.where(ok, st_c, -1).astype(pos_t))

        # verify the first n_verify confirmed offsets per read — as a
        # fori_loop over candidates so the verify temporaries stay O([R])
        # (the [R, n_verify, W+1] batched gather held ~5 GB at 4M-row
        # batches and ran out of device memory at the 10M bench)
        order = jnp.argsort(~in_range, axis=1, stable=True)[:, :n_verify]
        hasv = jnp.take_along_axis(in_range, order, axis=1)
        stv = jnp.take_along_axis(start_all, order, axis=1)
        stv_c = jnp.clip(stv, 0, pg_top)

        def vbody(j, carry):
            bm, bp = carry
            st = jax.lax.dynamic_slice_in_dim(stv_c, j, 1, axis=1)[:, 0]
            ok_j = jax.lax.dynamic_slice_in_dim(hasv, j, 1, axis=1)[:, 0]
            mis_j = _verify(read_lanes[:, :W], st, pg_lanes).astype(jnp.int32)
            mis_j = jnp.where(ok_j, mis_j, jnp.int32(255))
            # deterministic best: min mismatches, then min position
            better = (mis_j < bm) | ((mis_j == bm) & (st < bp))
            return (jnp.where(better, mis_j, bm).astype(jnp.int32),
                    jnp.where(better, st, bp).astype(pos_t))

        best_mis, best_pos = jax.lax.fori_loop(
            0, n_verify, vbody,
            (jnp.full((n_reads,), 255, jnp.int32),
             jnp.full((n_reads,), big_pos, pos_t)))
        ok = best_mis <= max_mis
        return (
            jnp.where(ok, best_mis, 255).astype(jnp.uint8),
            jnp.where(ok, best_pos, -1).astype(pos_t),
        )

    return probe_fn


def _build_probe_fn(n_reads: int, L: int, probe_offs: tuple, k: int,
                    i_pad: int, pg_lanes_len: int, max_mis: int, mesh=None,
                    wide: bool = False, n_verify: int = 1):
    """Jitted probe; with `mesh` the read rows are sharded over the "data"
    axis and the sorted index + packed pg stay replicated — each device
    runs its own local merge-join against the full index (the mapping of
    the reference's OMP per-read loop, ReadsMatchers.cpp:426-428).
    Results are identical to the single-device program."""
    jax, _ = _jax()
    if mesh is None:
        return jax.jit(_make_probe(n_reads, L, probe_offs, k, i_pad,
                                   pg_lanes_len, max_mis, wide, n_verify))
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    D = int(np.prod(mesh.devices.shape))
    local = _make_probe(n_reads // D, L, probe_offs, k, i_pad,
                        pg_lanes_len, max_mis, wide, n_verify)

    def local_gathered(*args):
        # replicate the per-shard results so every process of a multi-host
        # mesh can read the full output without a cross-host fetch (the
        # all-gather of [R] u8+pos rows is negligible next to the probe)
        mis, pos = local(*args)
        return (jax.lax.all_gather(mis, "data", tiled=True),
                jax.lax.all_gather(pos, "data", tiled=True))

    smapped = shard_map(
        local_gathered, mesh=mesh,
        in_specs=(P("data"), P(), P(), P(), P()),
        out_specs=(P(), P()),
        # the all_gather makes the outputs replicated by construction; the
        # varying-manner analysis cannot see that through the tiled gather
        check_vma=False,
    )
    return jax.jit(smapped)


_PROBE_CACHE: dict[tuple, object] = {}


def probe_offsets(L: int, k: int, k2: int) -> tuple:
    return tuple(int(o) for o in range(0, L - k + 1, k2))


def _spread_offsets(offs_full: tuple, k1: int) -> tuple:
    """Pass-1 probe offsets: k1 spread offsets whose residues mod k1 cover
    every class. The index samples pg positions every k1, so a read at pg
    position p has its offset-o anchor in the index iff (p+o) % k1 == 0 —
    offsets covering all residues guarantee EVERY error-free read at least
    one indexed exact anchor (without this, 1/k1 of clean reads miss all
    pass-1 anchors and fall through to the full fan-out; measured 78% ->
    ~35% pass-2 leftovers on the 200k bench)."""
    if k1 <= 1 or len(offs_full) <= k1:
        return offs_full
    chosen: list[int] = []
    need = set(range(k1))
    # seed with maximally spread picks, then fill missing residues with the
    # candidate closest to the largest gap
    seeds = [offs_full[round(i * (len(offs_full) - 1) / (k1 - 1))]
             for i in range(k1)]
    for o in seeds:
        if o % k1 in need:
            chosen.append(o)
            need.discard(o % k1)
    for r in sorted(need):
        cands = [o for o in offs_full if o % k1 == r and o not in chosen]
        if not cands:
            continue
        # prefer the candidate farthest from already-chosen offsets
        best = max(cands, key=lambda o: min(abs(o - c) for c in chosen))
        chosen.append(best)
    # residues can stay uncovered when gcd(k2, k1) > 1 (offs_full only hits
    # multiples of k2 mod k1); pad back up to k1 offsets with maximally
    # spread leftovers so pass-1 never probes FEWER windows than the k1
    # budget
    while len(chosen) < k1:
        cands = [o for o in offs_full if o not in chosen]
        if not cands:
            break
        chosen.append(max(cands,
                          key=lambda o: min(abs(o - c) for c in chosen)))
    return tuple(sorted(chosen))


@dataclass
class MatchResult:
    pos: np.ndarray       # [R] int64, -1 = unmatched
    rc: np.ndarray        # [R] bool
    mis: np.ndarray       # [R] uint8 (255 = unmatched)


def _probe_batch(rows_lanes, offs, index, dev, max_mis, L, batch_rows,
                 mesh=None, wide=False, n_verify=1, active_ranges=None):
    """Probe a [R, W+1] u32 lane batch in bucketed chunks.

    `dev` may carry several index BLOCKS (wide pgs whose sampled index
    exceeds the join's 2^29-entry program limit, the analog of the
    reference's uint_pg_len widening): each batch probes every block and
    results merge by the deterministic (mismatches, position) minimum.

    `active_ranges` = [(start, count), ...] limits probing to real rows
    (the [fwd | rc] layout pads each strand to a bucket multiple; without
    ranges the padding rows would be probed as full batches)."""
    jax, jnp = _jax()
    n = rows_lanes.shape[0]
    out_mis = np.full(n, 255, dtype=np.uint8)
    out_pos = np.full(n, -1, dtype=np.int64)
    blocks, pg_lanes_d, pg_lanes_len, i_pad = dev
    D = int(np.prod(mesh.devices.shape)) if mesh is not None else 1
    if D == 1:
        mesh = None
    if active_ranges is None:
        active_ranges = [(0, n)]
    spans = []
    for start, count in active_ranges:
        for lo in range(start, start + count, batch_rows):
            spans.append((lo, min(lo + batch_rows, start + count)))
    for lo, hi in spans:
        bn = hi - lo
        bsz = min(max(_probe_bucket(bn), D), batch_rows)
        hi_s = min(lo + bsz, n)  # bucket-sized slice (pow2-aligned)
        key = (bsz, L, offs, index.k, i_pad, pg_lanes_len, max_mis,
               D, wide, n_verify)
        if key not in _PROBE_CACHE:
            _PROBE_CACHE[key] = _build_probe_fn(
                bsz, L, offs, index.k, i_pad, pg_lanes_len, max_mis,
                mesh=mesh, wide=wide, n_verify=n_verify,
            )
        probe_fn = _PROBE_CACHE[key]
        lanes = _pad_rows(rows_lanes[lo:hi_s], bsz)
        # under a mesh, pass host numpy (placed per in_specs on every
        # process); single-device commits to the local device
        lanes_in = lanes if mesh is not None else jnp.asarray(lanes)
        for ihash_d, ipos_d in blocks:
            mis, pos = probe_fn(
                lanes_in, ihash_d, ipos_d, pg_lanes_d, index.pg_len,
            )
            mis_h, pos_h = jax.device_get((mis, pos))
            mis_b, pos_b = mis_h[:bn], pos_h[:bn].astype(np.int64)
            cur_m, cur_p = out_mis[lo:hi], out_pos[lo:hi]
            better = (mis_b < cur_m) | (
                (mis_b == cur_m) & (pos_b >= 0)
                & ((cur_p < 0) | (pos_b < cur_p)))
            out_mis[lo:hi] = np.where(better, mis_b, cur_m)
            out_pos[lo:hi] = np.where(better, pos_b, cur_p)
    return out_mis, out_pos


# index entries per block: big pgs' sampled indexes (134M entries at a
# 500M-symbol pg, up to 2^33 for wide pgs) are built and probed block by
# block so each join program's entry count — and so its device-memory
# footprint — stays bounded. A block entry is a u32 hash + i32/i64 position
# (8-12 B), 0.5-0.75 GB per 2^26-entry block
_MAX_INDEX_BLOCK = 1 << 26


def _build_index_build_fn(wpf: int, wp: int, k: int, k1: int, wide: bool):
    """Device program building one BLOCK of the sampled k-mer table from
    packed pg lanes.

    Input: pg_lanes [wpf] u32 (the FULL 2-bit packed pg, zero-padded to a
    pow2 bucket), lane_off scalar (the block's first lane), pg_len scalar.
    Output: (ihash [m] u32, ipos [m] i32/i64) for the wp lanes starting at
    lane_off, m = wp*16//k1; positions past pg_len-k marked -1 (inert to
    the probe join). One pg upload serves every block.

    Replaces the host _window_hashes + 12-bytes/entry table upload with a
    2-bit/symbol pg upload the probe needs anyway (CopMEMMatcher.cpp:
    139-324's index build, re-homed onto the device)."""
    jax, jnp = _jax()
    m = wp * 16 // k1
    pos_t = jnp.int64 if wide else jnp.int32
    assert 16 % k1 == 0, "device index build assumes k1 divides 16"
    phases = 16 // k1     # sample phases within one 16-symbol lane
    # lanes a window can span: k symbols starting at offset <= 15
    span_lanes = (15 + k + 15) // 16 + 1

    def build_fn(pg_lanes, lane_off, pg_len):
        # NO prefix scans: XLA's 67M-element cumsum/cumprod materialized
        # ~24 GB of stage temporaries (measured OOM at the 54M-symbol pg).
        # Instead each of the 16/k1 phases computes its window hashes by a
        # fully unrolled k-step Horner over strided lane slices — pure
        # elementwise streams, O(1) temporaries.
        padded = jnp.concatenate(
            [pg_lanes, jnp.zeros((span_lanes,), jnp.uint32)])
        sl = [jax.lax.dynamic_slice_in_dim(padded, lane_off + c, wp)
              for c in range(span_lanes)]
        out = []
        for pi in range(phases):
            r = pi * k1      # symbol offset within the lane
            h = jnp.zeros((wp,), jnp.uint32)
            for t in range(k):
                c, o = divmod(r + t, 16)
                v = (sl[c] >> jnp.uint32(2 * (15 - o))) & jnp.uint32(3)
                h = h * HASH_BASE + v
            out.append(h)
        # interleave phases back to position order: pos = lane*16 + r
        ihash = jnp.stack(out, axis=1).reshape(m)
        pos = (jnp.arange(m, dtype=pos_t) * pos_t(k1)
               + (lane_off * 16).astype(pos_t))
        ipos = jnp.where(pos <= pg_len - k, pos, pos_t(-1))
        return ihash, ipos

    return jax.jit(build_fn)


def device_index(index: KmerIndex, pg_codes: np.ndarray, wide: bool = False,
                 mesh=None, max_block: int | None = None):
    """Upload the index + packed pg text once per stage.

    The sort-merge probe needs NO pre-sorted index side (its min-position
    carry is order-independent), so index entries upload as-is; oversized
    indexes split into uniform blocks probed separately and merged by
    (mismatches, position) — see _probe_batch.

    Under a mesh the arrays stay host-side numpy: the jitted shard_map
    places them per its replicated in_specs on every call, which works
    identically on a single process and on a multi-host (jax.distributed)
    mesh where each process holds the same host value."""
    jax, jnp = _jax()
    pg_lanes = packed.pack_text_2bit(pg_codes)
    pg_lanes = _pad_1d(np.concatenate([pg_lanes, np.zeros(1, np.uint32)]),
                       _probe_bucket(len(pg_lanes) + 1))
    max_block = max_block or _MAX_INDEX_BLOCK
    wpf = len(pg_lanes)
    conv = (lambda a: a) if mesh is not None else jnp.asarray
    if index.hash_sorted is None and mesh is None:
        # lazy index: ONE pg upload (2 bit/symbol), table built on device —
        # in uniform lane blocks when the full table would exceed the join
        # program limit (500M-symbol pgs -> 134M entries)
        m_full = wpf * 16 // index.k1
        n_blocks = max(1, -(-m_full // max_block))
        wp = min(_probe_bucket(-(-wpf // n_blocks)), wpf)
        assert wpf % wp == 0  # pow2 over pow2: uniform in-bounds blocks
        n_blocks = wpf // wp
        pg_lanes_d = jnp.asarray(pg_lanes)
        key = ("ibuild", wpf, wp, index.k, index.k1, wide)
        if key not in _PROBE_CACHE:
            _PROBE_CACHE[key] = _build_index_build_fn(
                wpf, wp, index.k, index.k1, wide)
        blocks = []
        for b in range(n_blocks):
            ih, ip = _PROBE_CACHE[key](pg_lanes_d, np.int64(b * wp),
                                       index.pg_len)
            blocks.append((ih, ip))
        return (blocks, pg_lanes_d, wpf, wp * 16 // index.k1)
    if index.hash_sorted is None:
        # mesh replication path: host-built table
        hashes = _window_hashes(pg_codes, index.k)
        sampled = np.arange(0, index.pg_len - index.k + 1, index.k1,
                            dtype=np.int64)
        index = KmerIndex(hash_sorted=hashes[sampled], pos_sorted=sampled,
                          k=index.k, k1=index.k1, pg_len=index.pg_len,
                          sorted=False)
    n_ent = index.pos_sorted.size
    n_blocks = max(1, -(-n_ent // max_block))
    per = -(-max(n_ent, 1) // n_blocks)
    i_pad = _probe_bucket(per)
    blocks = []
    pos_dt = np.int64 if wide else np.int32
    for b in range(n_blocks):
        lo, hi = b * per, min((b + 1) * per, n_ent)
        ihash = _pad_1d(index.hash_sorted[lo:hi], i_pad)
        # pad positions with -1: the probe treats negative-pos entries as inert
        ipos = np.full(i_pad, -1, dtype=pos_dt)
        ipos[: hi - lo] = index.pos_sorted[lo:hi]
        blocks.append((conv(ihash), conv(ipos)))
    return (blocks, conv(pg_lanes), len(pg_lanes), i_pad)


def match_reads(
    read_codes: np.ndarray,
    index: KmerIndex,
    pg_codes: np.ndarray,
    max_mismatches: int,
    cap: int = DEFAULT_CAP,
    k2: int = DEFAULT_K2,
    batch: int = 65536,
    accept_mis: int = 2,
    mesh=None,
    force_wide: bool = False,
    index_block: int | None = None,
) -> MatchResult:
    """Match every read against the indexed pg, forward-first.

    N symbols in reads probe as A (2-bit packing collapses them); the
    encoder re-verifies N rows exactly (encoder.py stage 4).

    pgs past 2^31 symbols automatically switch to the wide (i64 position)
    probe variant; `force_wide` exercises it on small inputs (tests).
    """
    jax, jnp = _jax()
    n, L = read_codes.shape
    out_pos = np.full(n, -1, dtype=np.int64)
    out_rc = np.zeros(n, dtype=bool)
    out_mis = np.full(n, 255, dtype=np.uint8)
    if n == 0 or index.n_entries == 0 or index.pg_len < L:
        return MatchResult(out_pos, out_rc, out_mis)
    wide = force_wide or index.pg_len > 0x7FFF0000 - L
    if index.pg_len > (1 << 35):
        raise NotImplementedError(
            "pg longer than 2^35 symbols exceeds i32 lane indexing"
        )

    from ..utils.trace import span

    with span(f"match device_index pg={index.pg_len}"):
        dev = device_index(index, pg_codes, wide=wide, mesh=mesh,
                           max_block=index_block)
    offs_full = probe_offsets(L, index.k, k2)
    offs_p1 = _spread_offsets(offs_full, index.k1)
    # batch rows: as large as the join program limit allows, so the whole
    # pass is ONE dispatch whenever the join fits. Power-of-two sizes keep
    # compiled shapes few and mesh shards even.
    # With accept_mis == 0 (the NORMAL-level default) pass 1 cannot accept
    # any read carrying a mismatch, so the overwhelming majority falls
    # through to the full fan-out anyway (77% measured on the 2M bench) —
    # run ONE full-fan-out pass for every read instead: the probe compute
    # is nearly the same, but the whole pass-1 join and one
    # dispatch+readback cycle disappear. accept_mis > 0 (-l) keeps the
    # 2-phase structure: spread-offset pass 1 accepts early, leftovers
    # fan out.
    import os as _os

    n_verify2 = max(2, min(cap, 6))
    single_pass = accept_mis <= 0 and not _os.environ.get("PGRC_TWO_PASS")
    if single_pass:
        offs_p1 = offs_full
    i_pad = dev[3]
    b1 = _batch_cap(i_pad, len(offs_p1))
    b2 = _batch_cap(i_pad, len(offs_full))

    # pass 1: BOTH strands (on a strand-mixed input ~half the reads only
    # match reverse-complemented; probing rc keeps them out of a separate
    # rc pass — the reference instead rc-flips the whole pg and re-runs
    # matching, ReadsMatchers.cpp:162-184)
    with span(f"match pack n={n}"):
        lanes_f, nmask_f = packed.pack_lanes(read_codes)
    if mesh is None:
        # ONE forward-lanes upload; the RC strand is computed on device
        # (revcomp_lanes) — halves the host->device bytes
        nb = min(_probe_bucket(n), b1)
        key = ("rcprep", nb, L, nmask_f is not None)
        if key not in _PROBE_CACHE:
            def _prep(lanes, nmask):
                rc = packed.revcomp_lanes(lanes, L, nmask)
                return jnp.concatenate([lanes, rc], axis=0)

            _PROBE_CACHE[key] = jax.jit(_prep)
        nm = (jnp.asarray(_pad_rows(nmask_f, ((n - 1) // nb + 1) * nb))
              if nmask_f is not None else None)
        lanes_half = _pad_rows(lanes_f, ((n - 1) // nb + 1) * nb)
        parts = []
        for lo in range(0, lanes_half.shape[0], nb):
            parts.append(_PROBE_CACHE[key](
                jnp.asarray(lanes_half[lo:lo + nb]),
                nm[lo:lo + nb] if nm is not None else None))
        n_half = lanes_half.shape[0]
        if len(parts) == 1:
            lanes_fr = parts[0]
        else:
            lanes_fr = jnp.concatenate(
                [p[:nb] for p in parts] + [p[nb:] for p in parts], axis=0)
    else:
        rc_all = packed.revcomp_codes_matrix(read_codes)
        rc_all[rc_all > 3] = 0  # N probes as A on the RC strand too
        lanes_r, _ = packed.pack_lanes(rc_all)
        lanes_fr = np.concatenate([lanes_f, lanes_r])
        n_half = n
    with span(f"match pass1 rows=2x{n} offs={len(offs_p1)}"):
        bm, bp = _probe_batch(lanes_fr, offs_p1, index, dev, max_mismatches,
                              L, batch_rows=b1, mesh=mesh, wide=wide,
                              n_verify=n_verify2 if single_pass else 1,
                              active_ranges=[(0, n), (n_half, n)])
    fm, rm = bm[:n].copy(), bm[n_half:n_half + n].copy()
    fp, rp = bp[:n].copy(), bp[n_half:n_half + n].copy()

    # pass 2: full fan-out on both strands only for unaccepted leftovers,
    # best of the first `cap` confirmed anchors per read (skipped in
    # single-pass mode — pass 1 WAS the full fan-out)
    rows = (np.zeros(0, dtype=np.int64) if single_pass
            else np.nonzero(np.minimum(fm, rm) > accept_mis)[0])
    if rows.size:
        k = rows.size
        idxs = np.concatenate([rows, n_half + rows])
        if mesh is None:
            # gather the leftover rows on device (upload = 4 B/row of ids)
            bsub = _probe_bucket(idxs.size)
            key = ("p2gather", int(lanes_fr.shape[0]), bsub)
            if key not in _PROBE_CACHE:
                _PROBE_CACHE[key] = jax.jit(
                    lambda lf, ix: jnp.take(lf, ix, axis=0))
            ip_pad = np.zeros(bsub, dtype=np.int32)
            ip_pad[: idxs.size] = idxs
            sub = _PROBE_CACHE[key](lanes_fr, jnp.asarray(ip_pad))
        else:
            sub = np.concatenate([lanes_f[rows], lanes_r[rows]])
        with span(f"match pass2 rows={2 * k}"):
            mis_t, pos_t = _probe_batch(sub, offs_full, index, dev,
                                        max_mismatches, L, batch_rows=b2,
                                        mesh=mesh, wide=wide,
                                        n_verify=n_verify2,
                                        active_ranges=[(0, idxs.size)])
        better_f = mis_t[:k] < fm[rows]
        fm[rows] = np.where(better_f, mis_t[:k], fm[rows])
        fp[rows] = np.where(better_f, pos_t[:k], fp[rows])
        better_r = mis_t[k:2 * k] < rm[rows]
        rm[rows] = np.where(better_r, mis_t[k:2 * k], rm[rows])
        rp[rows] = np.where(better_r, pos_t[k:2 * k], rp[rows])

    # pass 3: interleaved-anchor rescue for reads both device passes missed
    # (burst errors can kill every contiguous k-mer anchor; an interleaved
    # anchor samples every 2nd symbol over a 2k window and survives them).
    # The pg-side interleaved index is built once and shared by both strands
    rows = np.nonzero(np.minimum(fm, rm) == 255)[0]
    k_resc = min(index.k, 16)
    # the rescue index cost is dominated by its pg sampling stride: widen
    # it with pg size (residue coverage of the 69 read offsets keeps
    # sensitivity) so the index stays ~1 s even at 50M-symbol pgs —
    # rescued reads are worth ~14 B of archive each (measured, 2M bench)
    k1_r = 2 if index.pg_len < (4 << 20) else \
        4 if index.pg_len < (32 << 20) else 8
    if rows.size >= 16 and L >= 2 * k_resc and pg_codes.size >= 2 * k_resc:
        with span(f"match rescue-index rows={rows.size} k1={k1_r}"):
            ridx = _build_rescue_index(pg_codes, k_resc, k1=k1_r)
        im, ip = _interleaved_rescue(read_codes[rows], pg_codes, k_resc,
                                     max_mismatches, k1=k1_r, ridx=ridx)
        better = im < fm[rows]
        fm[rows] = np.where(better, im, fm[rows])
        fp[rows] = np.where(better, ip, fp[rows])
        rc_sub = packed.revcomp_codes_matrix(read_codes[rows])
        rc_sub[rc_sub > 3] = 0
        im, ip = _interleaved_rescue(rc_sub, pg_codes, k_resc,
                                     max_mismatches, ridx=ridx)
        better = im < rm[rows]
        rm[rows] = np.where(better, im, rm[rows])
        rp[rows] = np.where(better, ip, rp[rows])

    take_r = rm < fm  # strict: forward wins ties (deterministic)
    out_mis[:] = np.where(take_r, rm, fm)
    out_pos[:] = np.where(take_r, rp, fp)
    out_rc[:] = take_r & (rm != 255)
    matched = out_mis != 255
    out_pos[~matched] = -1
    return MatchResult(out_pos, out_rc, out_mis)


def _build_rescue_index(pg_codes: np.ndarray, k: int, k1: int = 2,
                        bits: int = 20):
    """Interleaved-anchor CSR index of the pg: hash of every 2nd symbol
    over a 2k window at positions sampled every k1. Built once per stage
    and shared by the forward and rc rescue calls.

    Interleaved window hash at pg position p = contiguous window hash of
    the parity-(p%2) downsampled sequence at index p//2. With an EVEN k1
    every sampled position is even, so only the even-parity half sequence
    is ever hashed and the hash array is a strided view — the index then
    costs one half-length hash pass + one int radix argsort."""
    span = 2 * k
    n_s = max(pg_codes.size - span + 1, 0)
    if k1 % 2 == 0:
        half0 = _window_hashes(pg_codes[0::2], k)
        sampled = np.arange(0, n_s, k1, dtype=np.int64)
        hs = half0[:: k1 // 2][: sampled.size]
    else:
        half = [_window_hashes(pg_codes[0::2], k),
                _window_hashes(pg_codes[1::2], k)]
        sampled = np.arange(0, n_s, k1, dtype=np.int64)
        hs = np.where(sampled % 2 == 0,
                      half[0][np.clip(sampled // 2, 0, half[0].size - 1)],
                      half[1][np.clip(sampled // 2, 0,
                                      max(half[1].size - 1, 0))])
    hb = (hs >> np.uint32(32 - bits)).astype(np.int32)
    order = np.argsort(hb, kind="stable")
    counts = np.bincount(hb[order], minlength=1 << bits)
    starts = np.zeros((1 << bits) + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    return sampled[order], np.ascontiguousarray(hs)[order], starts, bits


def _interleaved_rescue(read_codes: np.ndarray, pg_codes: np.ndarray,
                        k: int, max_mis: int, k1: int = 2, k2: int = 1,
                        bits: int = 20, cap: int = 4, ridx=None):
    """Interleaved-pattern anchor matching for leftover reads (the
    InterleavedReadsApproxMatcher role, matching/ReadsMatchers.cpp:343-409):
    anchors hash every SECOND symbol of a 2k-wide window, so a burst of
    errors inside one contiguous k-mer cannot kill every anchor. Host
    numpy — this only ever runs on the few reads both device passes missed.

    Returns (mis uint8 [R], pos int64 [R]) in forward orientation.
    """
    n, L = read_codes.shape
    out_mis = np.full(n, 255, dtype=np.uint8)
    out_pos = np.full(n, -1, dtype=np.int64)
    span = 2 * k  # window width covered by one interleaved anchor
    if n == 0 or pg_codes.size < span or L < span:
        return out_mis, out_pos
    if ridx is None:
        ridx = _build_rescue_index(pg_codes, k, k1, bits)
    pos_s, h_s, starts, bits = ridx

    r_half0 = np.stack([_window_hashes(read_codes[r, 0::2], k)
                        for r in range(n)])
    r_half1 = np.stack([_window_hashes(read_codes[r, 1::2], k)
                        for r in range(n)])
    offs = np.arange(0, L - span + 1, k2, dtype=np.int64)
    for o in offs:
        rh = r_half0[:, o // 2] if o % 2 == 0 else r_half1[:, o // 2]
        b = (rh >> np.uint32(32 - bits)).astype(np.int64)
        lo = starts[b]
        cnt = np.minimum(starts[b + 1] - lo, cap)
        for c in range(cap):
            rows = np.nonzero(c < cnt)[0]
            if rows.size == 0:
                break
            j = lo[rows] + c
            okh = h_s[j] == rh[rows]
            # anchor parity must match the read offset parity relative to
            # the aligned start (start = anchor_pos - o)
            start = pos_s[j] - o
            valid = okh & (start >= 0) & (start <= pg_codes.size - L)
            rr = rows[valid]
            if rr.size == 0:
                continue
            st = start[valid]
            win = pg_codes[st[:, None] + np.arange(L)[None, :]]
            mis = (win != read_codes[rr]).sum(axis=1)
            better = (mis <= max_mis) & (
                (mis < out_mis[rr])
                | ((mis == out_mis[rr]) & (st < out_pos[rr]))
            )
            out_mis[rr[better]] = mis[better].astype(np.uint8)
            out_pos[rr[better]] = st[better]
    return out_mis, out_pos


def _pow2_floor(x: int) -> int:
    return 1 << (max(int(x), 1).bit_length() - 1)


def _batch_cap(i_pad: int, S: int) -> int:
    """Largest pow2 probe-row batch whose join (i_pad index entries +
    rows*S probes) stays within the program limit; the 2^22-row cap bounds
    the verify gather temporaries. Bigger batches matter: every batch
    re-sorts the i_pad index entries (at a 54M-symbol pg the index side is
    16.7M entries — 2^20-row batches re-sorted it 10x per pass). A join
    entry is a u32 hash + u32 key + u64 payload (16 B), so the 2^28-entry
    limit bounds one join sort's input at 4 GB (plus its output and
    scratch)."""
    room = ((1 << 28) - i_pad) // max(S, 1)
    return max(1024, min(1 << 22, _pow2_floor(room)))


def _probe_bucket(n: int) -> int:
    b = 1024
    while b < n:
        b *= 2
    return b


def _pad_rows(mat, n: int):
    if mat.shape[0] == n:
        return mat
    xp = packed._xp(mat)
    pad = xp.zeros((n - mat.shape[0], mat.shape[1]), dtype=mat.dtype)
    return xp.concatenate([mat, pad], axis=0)


def _pad_1d(arr: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad a 1-D array to length n (padding is only ever gathered under
    a mask, so the values are inert)."""
    if arr.shape[0] >= n:
        return arr
    return np.concatenate([arr, np.zeros(n - arr.shape[0], dtype=arr.dtype)])
