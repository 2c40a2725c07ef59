"""Device-side greedy shortest-common-superstring (pseudogenome) generator.

Re-design of the reference's greedy swiping overlap generator
(pseudogenome/generator/GreedySwipingPackedOverlapPseudoGenomeGenerator.cpp and
its Parallel twin): the same outer greedy structure — duplicates first, then
overlap lengths L-1 down to 1, each read getting at most one successor and one
predecessor — but each round is a data-parallel device program instead of a
sequential merge sweep:

  * reads live on device as packed 2-bit u32 lanes (+ a 1-bit N mask when
    the set contains N), so uploads, sorts, and verifies move 4-25x fewer
    bytes than a uint8 read matrix;
  * per-read rolling 64-bit polynomial hashes of the round's suffix and
    prefix are updated from ONE packed column per round;
  * each round is ONE kv-sort of the 2n (hash, side|gid) keys plus
    rank-for-rank pairing of suffixes with prefixes inside equal-hash
    groups via cumulative scans — the design assumes a multi-operand
    sort is cheaper than the random gathers and scatters of a hash-table
    design (it was on the accelerator the code was first written for;
    unmeasured on the H100). All scatters stay 32-bit;
  * candidate pairs are verified exactly with cross-lane shift compares on
    the packed lanes, so a hash collision can only cost a missed match,
    never a wrong link.

Cycle removal (cut the minimum-overlap edge of every cycle, reference
AbstractOverlapPseudoGenomeGenerator.cpp:6-41) and chain layout both use
pointer doubling; the pseudogenome is materialised with one vectorised
scatter, replacing the reference's sequential chain walk (:181-219).
"""
from __future__ import annotations

from dataclasses import dataclass
import numpy as np

from ..device import jax_modules as _jax

HASH_BASE = np.uint32(0x9E3779B1)  # odd -> invertible mod 2^32


def _modinv_u32(b: int) -> int:
    """Inverse of odd b modulo 2^32 (Newton iteration)."""
    x = b
    for _ in range(5):
        x = (x * (2 - b * x)) & 0xFFFFFFFF
    return x


HASH_BASE_INV = np.uint32(_modinv_u32(int(HASH_BASE)))

# 64-bit rolling-hash bases for the overlap rounds: pairing is by full 64-bit
# hash equality under base A, candidate pairs are confirmed by equality of an
# INDEPENDENT base-B hash (2^-128-class false-accept odds), and the final
# links get one exact host-side verification after the rounds — so the hot
# round program needs no packed-lane gathers at all
HASH_BASE64 = np.uint64(0x9E3779B97F4A7C15)
HASH_BASE64_INV = np.uint64(pow(int(HASH_BASE64), -1, 1 << 64))
HASH_BASE64B = np.uint64(0xC2B2AE3D27D4EB4F)
HASH_BASE64B_INV = np.uint64(pow(int(HASH_BASE64B), -1, 1 << 64))


@dataclass
class OverlapResult:
    succ: np.ndarray        # [N] int32, -1 = no successor
    overlap: np.ndarray     # [N] int32, overlap with successor
    read_len: int

    @property
    def pred(self) -> np.ndarray:
        n = self.succ.shape[0]
        pred = np.full(n, -1, dtype=np.int32)
        has = self.succ >= 0
        pred[self.succ[has]] = np.nonzero(has)[0].astype(np.int32)
        return pred


# ---------------------------------------------------------------------------
# device rounds
# ---------------------------------------------------------------------------


def _pow_table(L: int) -> np.ndarray:
    pows = np.ones(L + 1, dtype=np.uint32)
    b = int(HASH_BASE)
    v = 1
    for k in range(1, L + 1):
        v = (v * b) & 0xFFFFFFFF
        pows[k] = v
    return pows


def _pow_table64(L: int, base: np.uint64 = HASH_BASE64) -> np.ndarray:
    pows = np.ones(L + 1, dtype=np.uint64)
    b = int(base)
    v = 1
    for k in range(1, L + 1):
        v = (v * b) & 0xFFFFFFFFFFFFFFFF
        pows[k] = np.uint64(v)
    return pows


def _lane_dims(L: int) -> tuple[int, int]:
    """(W, Wn): 2-bit lane count and N-bitmask lane count for read length L."""
    return (L + 15) // 16, (L + 31) // 32


def _col_vals(jax, jnp, lanes, nmask, t, has_n):
    """Symbol value (0..7: 2-bit code + 4*N-bit) of column t of every row —
    extracted from packed lanes with a dynamic lane slice + shift."""
    q = t // 16
    r = t % 16
    lane = jax.lax.dynamic_slice_in_dim(lanes, q, 1, axis=1)[:, 0]
    c = (lane >> (jnp.uint32(2) * (jnp.uint32(15) - r.astype(jnp.uint32)))) & jnp.uint32(3)
    if has_n:
        qn = t // 32
        rn = t % 32
        lanen = jax.lax.dynamic_slice_in_dim(nmask, qn, 1, axis=1)[:, 0]
        nb = (lanen >> (jnp.uint32(31) - rn.astype(jnp.uint32))) & jnp.uint32(1)
        c = c + (nb << jnp.uint32(2))
    return c


def _build_seg_fn(n: int, L: int, has_n: bool, n_glob: int, mesh=None):
    """A segment of overlap rounds [i0, i1) at local table size `n` as one
    device program. Per-row state (hashes, active flags, pending links,
    orig ids) is local to the compacted table; links flush to the global
    succ/ovl arrays (original read-id space) once per segment, so the host
    can shrink the local table between segments without remapping anything.

    Each round is THREE kv-sorts and zero gathers/scatters: every
    gather/scatter is converted into a sort + elementwise shift, on the
    assumption that a random gather costs more than a multi-operand sort
    of the same entries (unmeasured on the H100):

      sort 1  (hash, side|gid)            — groups equal-hash entries,
              prefixes before suffixes, each side ordered by global id;
              segmented SCANS then give every entry its in-group rank.
      sort 2  (hash, rank*2+side)         — makes each suffix ADJACENT to
              its rank-partner prefix, so partner gid / confirm-hash come
              from an elementwise shift instead of a gather.
      sort 3  (side*n+row)                — returns per-entry results to
              canonical row order, so the row-state update is a slice+OR
              instead of a scatter.

    Candidate pairs are CONFIRMED by equality of an independent second
    64-bit rolling hash carried through the sorts as a payload (replacing
    the per-round exact packed-lane verify, whose [n, W] gathers dominated
    round cost — a pair is accepted only when two independent polynomial
    hashes both match, and the final links get one exact host-side
    verification after the rounds, so a double collision can still only
    cost a dropped link, never a wrong byte).

    A read whose suffix equals its own prefix is never linked to itself;
    its prefix is still consumed that round (a conservative, deterministic
    over-claim that can only lose a rare match). Every tie-break is on
    GLOBAL read ids, so the result is independent of row partitioning:
    with `mesh` set, each device builds entries for its row shard,
    all-gathers the keys, and runs the same global sort+pairing — links
    apply only to local rows and merge with pmax at segment end —
    byte-identical to the 1-device run (the OMP-loops-to-collectives
    mapping of SURVEY §2.8).

    Reference: GreedySwipingPackedOverlapPseudoGenomeGenerator.cpp:171-249
    (per-overlap-length merge sweeps) and its Parallel twin :255-292."""
    jax, jnp = _jax()

    # closure constants stay numpy: a closed-over jax device array is
    # fetched device->host at lowering time to embed as an MLIR constant
    pows64 = _pow_table64(L)
    pows64b = _pow_table64(L, HASH_BASE64B)
    inv64 = np.uint64(HASH_BASE64_INV)
    inv64b = np.uint64(HASH_BASE64B_INV)
    axis = "data" if mesh is not None else None
    D = _mesh_size(mesh)
    m = 2 * n * D                   # total sorted entries
    BIGI = np.int32(m + 2)
    INV64 = np.uint64(0xFFFFFFFFFFFFFFFF)
    INV32 = np.uint32(0xFFFFFFFF)
    if n_glob >= (1 << 30):
        raise NotImplementedError(
            "overlap rounds index reads with 31-bit packed ids"
        )

    def _allsum(x):
        return jax.lax.psum(x, axis) if axis else x

    def round_fn(i, lanes, nmask, ids, rows, h, p, h2, p2,
                 active_s, active_p, succ_l, ovl_l):
        # --- rolling hash updates (suffix drops column i-1, prefix drops
        #     column L-i) — these run every round even if matching is
        #     skipped, the recurrences are cumulative ---
        vi = _col_vals(jax, jnp, lanes, nmask, i - 1, has_n).astype(jnp.uint64)
        h = h - vi * jnp.asarray(pows64)[L - i]
        h2 = h2 - vi * jnp.asarray(pows64b)[L - i]
        vm = _col_vals(jax, jnp, lanes, nmask, L - i, has_n).astype(jnp.uint64)
        p = (p - vm) * inv64
        p2 = (p2 - vm) * inv64b

        def do_match(args):
            h, p, h2, p2, active_s, active_p, succ_l, ovl_l = args
            gid_u = ids.astype(jnp.uint32)
            # --- 2n entries: prefixes first inside an equal-hash group,
            # each side ordered by global id (deterministic ranks). orig =
            # side * n_glob + row-identity is the canonical row order that
            # sort 3 restores (rows are global ids under mesh, so the same
            # expression works sharded) ---
            n_tot = n_glob if axis else n
            k1 = jnp.concatenate([jnp.where(active_p, p, INV64),
                                  jnp.where(active_s, h, INV64)])
            k2 = jnp.concatenate([
                jnp.where(active_p, gid_u, INV32),
                jnp.where(active_s, gid_u | jnp.uint32(0x80000000), INV32),
            ])
            orig = jnp.concatenate([rows, rows + jnp.int32(n_tot)])
            v2 = jnp.concatenate([p2, h2])       # confirm hash per entry
            if axis:
                k1 = jax.lax.all_gather(k1, axis, tiled=True)
                k2 = jax.lax.all_gather(k2, axis, tiled=True)
                orig = jax.lax.all_gather(orig, axis, tiled=True)
                v2 = jax.lax.all_gather(v2, axis, tiled=True)
            k1s, k2s, origs, v2s = jax.lax.sort((k1, k2, orig, v2),
                                                num_keys=2, is_stable=False)

            idx = jnp.arange(m, dtype=jnp.int32)
            valid = k2s != INV32
            side_suf = (k2s & jnp.uint32(0x80000000)) != 0
            same_prev = jnp.concatenate(
                [jnp.zeros(1, jnp.bool_), k1s[1:] == k1s[:-1]])
            boundary = valid & ~same_prev
            is_suf = valid & side_suf
            # segmented ranks via scans: seg_start = my group's first entry,
            # fs_bwd = my group's first suffix (suffix ranks count from it,
            # prefix ranks from seg_start)
            seg_start = jax.lax.cummax(jnp.where(boundary, idx, 0))
            prev_is_suf = jnp.concatenate(
                [jnp.zeros(1, jnp.bool_), is_suf[:-1]])
            first_suf = is_suf & (~prev_is_suf | boundary)
            fs_bwd = jax.lax.cummax(jnp.where(first_suf, idx, -1))
            rank = jnp.where(is_suf, idx - jnp.maximum(fs_bwd, 0),
                             idx - seg_start)
            # sort 2: (hash, rank*2+side) puts each suffix immediately after
            # its rank-partner prefix — partner attributes become shifts.
            # payload packs (side|gid, orig) into one u64
            skey = jnp.where(
                valid,
                (rank.astype(jnp.uint32) << 1)
                | jnp.where(side_suf & (fs_bwd >= 0), jnp.uint32(1),
                            jnp.uint32(0)),
                INV32)
            skey = jnp.where(is_suf & (fs_bwd < 0), INV32 - jnp.uint32(1),
                             skey)  # suffix group with no suffix start: inert
            pay = (k2s.astype(jnp.uint64) << jnp.uint64(32)) \
                | origs.astype(jnp.uint32).astype(jnp.uint64)
            k1t, skeyt, payt, v2t = jax.lax.sort((k1s, skey, pay, v2s),
                                                 num_keys=2, is_stable=False)
            k2t = (payt >> jnp.uint64(32)).astype(jnp.uint32)
            origt = (payt & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32).astype(jnp.int32)
            valid_t = k2t != INV32
            gid_t = (k2t & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
            is_suf_t = valid_t & ((skeyt & jnp.uint32(1)) == 1)
            is_pref_t = valid_t & ((skeyt & jnp.uint32(1)) == 0)
            prev = lambda x, fill: jnp.concatenate([jnp.full(1, fill, x.dtype), x[:-1]])
            nxt = lambda x, fill: jnp.concatenate([x[1:], jnp.full(1, fill, x.dtype)])
            # suffix: previous entry is its rank-partner prefix
            prev_partner = (prev(k1t, INV64) == k1t) \
                & (prev(skeyt, INV32) == skeyt - jnp.uint32(1)) \
                & prev(valid_t, False)
            suf_ok = is_suf_t & prev_partner \
                & (prev(gid_t, -1) != gid_t) \
                & (prev(v2t, jnp.uint64(0)) == v2t)
            # prefix: claimed iff a suffix of the same rank exists (it sorts
            # immediately after), independent of that pair's verification —
            # the conservative over-claim of the gather design, preserved
            claimed_t = is_pref_t & (nxt(k1t, INV64) == k1t) \
                & (nxt(skeyt, INV32) == skeyt + jnp.uint32(1))
            val_t = jnp.where(suf_ok,
                              prev(gid_t, -1).astype(jnp.uint32) + jnp.uint32(1),
                              jnp.uint32(0)) \
                | jnp.where(claimed_t, jnp.uint32(0x80000000), jnp.uint32(0))
            if axis:
                # sharded tables may hold arbitrary (compacted) id subsets,
                # so route via one scatter to (side, gid) coordinates and a
                # per-device gather of its own ids — only the mesh path
                # pays the scatter/gather, the 1-device path stays all-sort
                tbl = jnp.zeros((2 * n_glob,), jnp.uint32).at[origt].set(
                    val_t, mode="drop")
                val_pref = jnp.take(tbl, ids)
                val_suf = jnp.take(tbl, ids + jnp.int32(n_glob))
            else:
                # sort 3: canonical row order; the row update is a slice+OR
                orig3, val3 = jax.lax.sort((origt, val_t), num_keys=1,
                                           is_stable=False)
                val_pref = val3[:n]
                val_suf = val3[n : 2 * n]

            cand = (val_suf & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32) - 1
            claimed_row = (val_pref & jnp.uint32(0x80000000)) != 0
            matched = cand >= 0

            # --- pending links: elementwise row-state merge (no scatter);
            # flushed to the global arrays once per segment ---
            ovl_new = jnp.int32(L) - i.astype(jnp.int32)
            succ_l = jnp.where(matched, cand, succ_l)
            ovl_l = jnp.where(matched, ovl_new, ovl_l)
            active_s = active_s & ~matched
            active_p = active_p & ~claimed_row
            return h, p, h2, p2, active_s, active_p, succ_l, ovl_l

        some_work = _allsum(active_s.any().astype(jnp.int32)) > 0
        some_work = some_work & (_allsum(active_p.any().astype(jnp.int32)) > 0)
        return jax.lax.cond(
            some_work, do_match, lambda a: (h, p, h2, p2) + a[4:],
            (h, p, h2, p2, active_s, active_p, succ_l, ovl_l),
        )

    def seg_fn(lanes, nmask, ids, h, p, h2, p2,
               active_s, active_p, succ_l, ovl_l, succ_g, ovl_g, i0, i1):
        if axis:
            # entry payload identifying a row across devices: the global id
            # doubles as the global row (no compaction under mesh)
            rows = ids
            # NOTE: jax.lax.pvary is deprecated in favor of pcast, but in
            # this jax build pcast(to='varying') mis-infers the mesh axes
            # here (3 mesh tests fail); keep pvary until pcast stabilizes
            succ_g = jax.lax.pvary(succ_g, axis)
            ovl_g = jax.lax.pvary(ovl_g, axis)
        else:
            rows = jnp.arange(n, dtype=jnp.int32)

        def body(i, carry):
            h, p, h2, p2, a_s, a_p, sl, ol = carry
            return round_fn(jnp.int32(i), lanes, nmask, ids, rows,
                            h, p, h2, p2, a_s, a_p, sl, ol)

        carry = (h, p, h2, p2, active_s, active_p, succ_l, ovl_l)
        carry = jax.lax.fori_loop(i0, i1, body, carry)
        h, p, h2, p2, a_s, a_p, sl, ol = carry
        # flush pending links to global id space (two i32 scatters/segment)
        flush = sl >= 0
        tgt = jnp.where(flush, ids, n_glob)
        sg = succ_g.at[tgt].set(sl, mode="drop")
        og = ovl_g.at[tgt].set(ol, mode="drop")
        if axis:
            # each global id's link is written on exactly one device (rows
            # are disjoint and a row links at most once): max-merge replicas
            sg = jax.lax.pmax(sg, axis)
            og = jax.lax.pmax(og, axis)
        loc_act = (a_s | a_p).sum(dtype=jnp.int32)
        n_active = _allsum(loc_act)
        # per-device max drives the compaction ladder under mesh (tables
        # must stay uniform across devices; a skewed shard sets the size)
        n_act_max = jax.lax.pmax(loc_act, axis) if axis else n_active
        n_suf = _allsum(a_s.sum(dtype=jnp.int32))
        n_pref = _allsum(a_p.sum(dtype=jnp.int32))
        return (h, p, h2, p2, a_s, a_p, sl, ol, sg, og,
                n_active, n_act_max, n_suf, n_pref)

    if mesh is None:
        return jax.jit(seg_fn)

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    S, R = P("data"), P()
    smapped = shard_map(
        seg_fn,
        mesh=mesh,
        in_specs=(S, S, S, S, S, S, S, S, S, S, S, R, R, R, R),
        out_specs=(S, S, S, S, S, S, S, S, R, R, R, R, R, R),
    )
    return jax.jit(smapped)


def _build_init_fn(n: int, L: int, has_n: bool):
    """Initial device program: full-read hashes + duplicate linking
    (GreedySwipingPacked...cpp:97-136's equal-neighbor dedup) at full size.
    Emits links directly in global id space (ids are the identity here).

    Duplicate acceptance is by equality of BOTH independent 64-bit hashes
    (carried through the sort as a payload — no row gathers); the exact
    host-side _verify_links pass covers overlap-L links too, so a double
    collision costs a dropped duplicate link, never a wrong byte."""
    jax, jnp = _jax()
    INVALID64 = np.uint64(0xFFFFFFFFFFFFFFFF)

    def init_fn(lanes, nmask, nreal):
        # h0[r] = sum_j v[r,j] * B^(L-1-j) by Horner over columns — a
        # fori_loop of [n] elementwise steps keeps the program tiny and its
        # temporaries O([n]) (an unpack-to-[n, L] + reduce formulation
        # holds an [n, L] u64 matrix)
        def horner(t, c):
            ha, hb = c
            v = _col_vals(jax, jnp, lanes, nmask, jnp.int32(t), has_n
                          ).astype(jnp.uint64)
            return (ha * HASH_BASE64 + v, hb * HASH_BASE64B + v)

        z = jnp.zeros((n,), jnp.uint64)
        h0, h0b = jax.lax.fori_loop(0, L, horner, (z, z))
        idx = jnp.arange(n, dtype=jnp.int32)
        real = idx < nreal
        ks = jnp.where(real, jnp.minimum(h0, INVALID64 - np.uint64(1)),
                       INVALID64)
        ks_sorted, sidx, hb_sorted = jax.lax.sort((ks, idx, h0b), num_keys=1,
                                                  is_stable=True)
        nxt_key_same = jnp.concatenate(
            [(ks_sorted[1:] == ks_sorted[:-1]) & (ks_sorted[1:] != INVALID64),
             jnp.zeros(1, dtype=jnp.bool_)]
        )
        me = sidx
        nxt = jnp.clip(jnp.concatenate([sidx[1:], sidx[:1]]), 0, n - 1)
        eq = jnp.concatenate([hb_sorted[1:] == hb_sorted[:-1],
                              jnp.zeros(1, dtype=jnp.bool_)])
        matched = nxt_key_same & eq
        succ = jnp.full((n,), -1, dtype=jnp.int32)
        ovl = jnp.zeros((n,), dtype=jnp.int32)
        succ = succ.at[jnp.where(matched, me, n)].set(jnp.where(matched, nxt, -1), mode="drop")
        ovl = ovl.at[jnp.where(matched, me, n)].set(L, mode="drop")
        active_s = (succ < 0) & real
        has_pred = jnp.zeros((n,), dtype=jnp.bool_).at[
            jnp.where(matched, nxt, n)
        ].set(True, mode="drop")
        active_p = ~has_pred & real
        return h0, h0b, active_s, active_p, succ, ovl

    return jax.jit(init_fn)


def _build_hash_fn(n: int, L: int, has_n: bool):
    """Hash-only init (repair mode): full-read rolling hashes, no linking."""
    jax, jnp = _jax()

    def hash_fn(lanes, nmask):
        def horner(t, c):
            ha, hb = c
            v = _col_vals(jax, jnp, lanes, nmask, jnp.int32(t), has_n
                          ).astype(jnp.uint64)
            return (ha * HASH_BASE64 + v, hb * HASH_BASE64B + v)

        z = jnp.zeros((n,), jnp.uint64)
        return jax.lax.fori_loop(0, L, horner, (z, z))

    return jax.jit(hash_fn)


def _build_compact_fn(n_old: int, n_new: int, L: int, has_n: bool, mesh=None):
    """Device-side table compaction: stable-partition active rows to the
    front (one kv sort of n_old keys) and gather the first n_new rows of
    every per-row array. Dropped rows have already written their links to
    the global succ/ovl arrays, so no information is lost."""
    jax, jnp = _jax()

    def compact_fn(lanes, nmask, ids, h, p, h2, p2, a_s, a_p, succ_l, ovl_l):
        pos = jnp.arange(n_old, dtype=jnp.int32)
        drop = (~(a_s | a_p)).astype(jnp.int32)
        _, perm = jax.lax.sort((drop, pos), num_keys=1, is_stable=True)
        sel = perm[:n_new]
        return (
            jnp.take(lanes, sel, axis=0),
            jnp.take(nmask, sel, axis=0) if has_n else nmask,
            jnp.take(ids, sel),
            jnp.take(h, sel),
            jnp.take(p, sel),
            jnp.take(h2, sel),
            jnp.take(p2, sel),
            jnp.take(a_s, sel),
            jnp.take(a_p, sel),
            jnp.take(succ_l, sel),
            jnp.take(ovl_l, sel),
        )

    if mesh is None:
        return jax.jit(compact_fn)

    # per-device local compaction: each shard stable-partitions ITS rows
    # (ids are global, so dropping rows never loses links — they were
    # flushed at the last segment end, exactly as on one device)
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    S = P("data")
    smapped = shard_map(
        compact_fn, mesh=mesh,
        in_specs=(S,) * 11, out_specs=(S,) * 11,
    )
    return jax.jit(smapped)


def _mesh_size(mesh) -> int:
    return int(np.prod(mesh.devices.shape)) if mesh is not None else 1


_FN_CACHE: dict[tuple, object] = {}


def _cached(kind: str, builder, *shape) -> object:
    key = (kind, *shape)
    if key not in _FN_CACHE:
        _FN_CACHE[key] = builder(*shape)
    return _FN_CACHE[key]


# segment lengths between host syncs: short early (active set collapses
# fastest in the first high-overlap rounds), longer later
_SEG_PLAN = (6, 6, 12, 12, 24, 24)
_SEG_TAIL = 48
_COMPACT_FLOOR = 4096

# row count at or below which the sweep runs as plain numpy on the host:
# a device round is dominated by dispatch latency at these sizes (stage-5
# lq/N sets are typically a handful of reads yet paid ~0.17 s of device
# round-trips). The host mirror reproduces the device rounds' semantics
# bit-for-bit (same hashes, same tie-breaks), so the dispatch choice can
# never change an archive.
_HOST_SWEEP_MAX = 3072

# device sweep table cap: a table of n rows sorts 2n 24-byte entries per
# round (u64 hash, u32 side|gid, i32 row, u64 confirm hash), i.e. 48 B per
# row per sort input, plus the sort's output and scratch, the packed lanes
# (4 B per 16 bases) and 4 u64 hash states (32 B per row) — an estimated
# ~230 B per row at 100 bp, ~11 GB at the cap, inside an 80 GB card. Past the cap the sweep
# PARTITIONS:
# each part sweeps independently, then one repair sweep over the free
# ends links across parts (the 100M-read enablement; coverage data loses
# little because parts stay at high coverage)
_SWEEP_MAX_ROWS = 48_000_000


def _find_overlaps_host(codes: np.ndarray, coef: float = 1.0,
                        init_state=None) -> OverlapResult:
    """Numpy mirror of the device sweep (init duplicate-linking + rounds).

    Semantics are identical to the device program — full-read 64-bit hash
    sort with stable-id dedup links, then per-round rank-pairing of
    equal-hash suffix/prefix groups with the same global-id tie-breaks,
    second-hash confirmation, and the conservative prefix claim — so host
    and device paths produce the same links for the same input."""
    n, L = codes.shape
    v = codes.astype(np.uint64)          # symbol value incl. N (= 4)
    pows64 = _pow_table64(L)
    pows64b = _pow_table64(L, HASH_BASE64B)
    inv64 = np.uint64(HASH_BASE64_INV)
    inv64b = np.uint64(HASH_BASE64B_INV)
    INV64 = np.uint64(0xFFFFFFFFFFFFFFFF)

    # full-read hashes (Horner)
    h0 = np.zeros(n, dtype=np.uint64)
    h0b = np.zeros(n, dtype=np.uint64)
    for t in range(L):
        h0 = h0 * HASH_BASE64 + v[:, t]
        h0b = h0b * HASH_BASE64B + v[:, t]

    if init_state is None:
        succ = np.full(n, -1, dtype=np.int32)
        ovl = np.zeros(n, dtype=np.int32)
        # duplicate linking: stable hash sort, equal-exact neighbors link
        ks = np.minimum(h0, INV64 - np.uint64(1))
        sidx = np.argsort(ks, kind="stable")
        ks_s = ks[sidx]
        nxt_same = np.zeros(n, dtype=bool)
        if n > 1:
            nxt_same[:-1] = ks_s[1:] == ks_s[:-1]
            eq = (codes[sidx[:-1]] == codes[sidx[1:]]).all(axis=1)
            m = nxt_same[:-1] & eq
            me, nx = sidx[:-1][m], sidx[1:][m]
            succ[me] = nx
            ovl[me] = L
            has_pred = np.zeros(n, dtype=bool)
            has_pred[nx] = True
        else:
            has_pred = np.zeros(n, dtype=bool)
        active_s = succ < 0
        active_p = ~has_pred
    else:
        succ0, ovl0, a_s0, a_p0 = init_state
        succ = succ0.astype(np.int32).copy()
        ovl = ovl0.astype(np.int32).copy()
        active_s = a_s0.copy()
        active_p = a_p0.copy()

    h, p = h0.copy(), h0.copy()
    h2, p2 = h0b.copy(), h0b.copy()
    iters = int(L * coef)
    for i in range(1, iters):
        # rolling updates (cumulative — run even when matching skips)
        h = h - v[:, i - 1] * pows64[L - i]
        h2 = h2 - v[:, i - 1] * pows64b[L - i]
        p = (p - v[:, L - i]) * inv64
        p2 = (p2 - v[:, L - i]) * inv64b
        sufs = np.nonzero(active_s)[0]
        prefs = np.nonzero(active_p)[0]
        if sufs.size == 0 or prefs.size == 0:
            break
        # group by hash value; prefixes before suffixes, each side by gid
        key = np.concatenate([p[prefs], h[sufs]])
        side = np.concatenate([np.zeros(prefs.size, np.uint8),
                               np.ones(sufs.size, np.uint8)])
        gid = np.concatenate([prefs, sufs]).astype(np.int64)
        order = np.lexsort((gid, side, key))
        k_s, s_s, g_s = key[order], side[order], gid[order]
        m = order.size
        idx = np.arange(m, dtype=np.int64)
        boundary = np.ones(m, dtype=bool)
        boundary[1:] = k_s[1:] != k_s[:-1]
        seg_start = np.maximum.accumulate(np.where(boundary, idx, 0))
        is_suf = s_s == 1
        prev_is_suf = np.zeros(m, dtype=bool)
        prev_is_suf[1:] = is_suf[:-1]
        first_suf = is_suf & (~prev_is_suf | boundary)
        fs_bwd = np.maximum.accumulate(np.where(first_suf, idx, -1))
        # suffix rank-k pairs the prefix with rank k of the same group
        srows = np.nonzero(is_suf & (fs_bwd >= 0))[0]
        rank = srows - fs_bwd[srows]
        npref = fs_bwd[srows] - seg_start[srows]
        paired = rank < npref
        sj = srows[paired]
        partner = seg_start[sj] + rank[paired]
        a = g_s[sj]                # suffix read
        b = g_s[partner]           # prefix read
        okl = (a != b) & (h2[a] == p2[b])
        succ[a[okl]] = b[okl].astype(np.int32)
        ovl[a[okl]] = np.int32(L - i)
        active_s[a[okl]] = False
        # prefix rank-k claimed iff a suffix of rank k exists (independent
        # of that pair's confirmation — the conservative over-claim)
        starts = idx[boundary]
        ends = np.concatenate([starts[1:], [m]])
        # group's first suffix: fs_bwd at the group's LAST entry is its own
        # first_suf when the group has suffixes (they are contiguous at the
        # group end), else an earlier group's (< starts -> no suffixes)
        fs_end = fs_bwd[ends - 1]
        fs = np.where(fs_end >= starts, fs_end, ends)
        n_suf_grp = ends - fs
        grp_id = np.cumsum(boundary) - 1
        prows = np.nonzero(~is_suf)[0]
        prank = prows - seg_start[prows]
        claimed = prank < n_suf_grp[grp_id[prows]]
        active_p[g_s[prows[claimed]]] = False
    res = OverlapResult(succ, ovl, L)
    _verify_links(res, codes)
    return res


def find_overlaps(codes: np.ndarray, coef: float = 1.0, mesh=None,
                  init_active=None) -> OverlapResult:
    """Run duplicate linking + overlap rounds; returns successor links.

    coef < 1 limits rounds like the reference's overlappedReadsCountStopCoef
    (overlap lengths L-1 .. L-(L*coef-1)); coef == 1 goes down to overlap 1.

    `init_active` = (active_s, active_p) bool masks: skip the duplicate-
    linking init and run rounds with only the given suffix/prefix ends
    active (the repair-sweep mode of divide_and_generate). Rows inactive on
    both sides still participate as... nothing: callers should pass only
    the needed rows (repair_links compacts for them).

    The sweep runs in segments of rounds; between segments the host reads
    back only the active counts (one small sync) and, when the active set
    has collapsed enough, compacts the device table to the next
    power-of-two bucket — per-round cost is linear in the table size, and
    on coverage-shaped data the active set shrinks geometrically. Replaces
    the reference's per-iteration suffix re-bucketing
    (ParallelGreedySwiping...cpp:213-252) as the work-shrinking mechanism.

    With `mesh` (a 1-D jax Mesh over axis "data") the rounds run sharded:
    rows are data-parallel across devices, the per-round id/hash tables and
    claims merge via pmin/psum collectives, and link tie-breaks use global
    read ids — the archive is byte-identical to the 1-device run.
    """
    n, L = codes.shape
    if n == 0:
        return OverlapResult(np.zeros(0, np.int32), np.zeros(0, np.int32), L)
    if n == 1:
        return OverlapResult(np.full(1, -1, np.int32), np.zeros(1, np.int32), L)
    D = _mesh_size(mesh)
    if D == 1:
        mesh = None
    if mesh is None and n <= _HOST_SWEEP_MAX:
        if init_active is None:
            return _find_overlaps_host(codes, coef)
        a_s0, a_p0 = init_active
        return _find_overlaps_host(
            codes, coef,
            init_state=(np.full(n, -1, np.int32), np.zeros(n, np.int32),
                        a_s0.copy(), a_p0.copy()))
    if n > _SWEEP_MAX_ROWS and init_active is None:
        return _find_overlaps_partitioned(codes, coef, mesh)
    jax, jnp = _jax()
    from ..core import packed as packed_mod

    # bucket N to limit distinct compiled shapes; padding rows are inert
    # (zero reads marked inactive in both tables from the start).
    # D is a power of two <= every bucket size, so shards divide evenly.
    from ..utils.trace import span

    n_pad = max(_bucket_size(n), D)
    with span(f"sweep pack+upload n={n} pad={n_pad}"):
        lanes_np, nmask_np = packed_mod.pack_lanes(codes, n_pad)
        has_n = nmask_np is not None

        lanes_d = jnp.asarray(lanes_np)
    nmask_d = jnp.asarray(nmask_np) if has_n else jnp.zeros((n_pad, 1), dtype=jnp.uint32)
    if init_active is None:
        init_fn = _cached("init", _build_init_fn, n_pad, L, has_n)
        h0, h0b, a_s, a_p, succ_g, ovl_g = init_fn(lanes_d, nmask_d,
                                                   jnp.int32(n))
    else:
        # repair mode: hashes only, actives from the caller, no links yet
        hash_fn = _cached("hash", _build_hash_fn, n_pad, L, has_n)
        h0, h0b = hash_fn(lanes_d, nmask_d)
        a_s = np.zeros(n_pad, dtype=bool)
        a_p = np.zeros(n_pad, dtype=bool)
        a_s[:n], a_p[:n] = init_active
        succ_g = np.full(n_pad, -1, dtype=np.int32)
        ovl_g = np.zeros(n_pad, dtype=np.int32)
        if mesh is None:
            a_s, a_p = jnp.asarray(a_s), jnp.asarray(a_p)
            succ_g, ovl_g = jnp.asarray(succ_g), jnp.asarray(ovl_g)
    ids = jnp.arange(n_pad, dtype=jnp.int32)
    if mesh is not None:
        # init ran as a single-device program; hand the arrays back to host
        # so the sharded segment program is free to lay them out per-shard.
        # The lane tables and ids go back to numpy too: every process of a
        # multi-host mesh holds the same host value and the jitted shard_map
        # places its own shards per in_specs (jax.distributed over DCN,
        # SURVEY §2.8)
        h0, h0b, a_s, a_p, succ_g, ovl_g = jax.device_get(
            (h0, h0b, a_s, a_p, succ_g, ovl_g))
        lanes_d = lanes_np
        nmask_d = (nmask_np if has_n
                   else np.zeros((n_pad, 1), dtype=np.uint32))
        ids = np.arange(n_pad, dtype=np.int32)
    else:
        # the packed host copy (~0.5 GB at 10M reads) is only needed for
        # the mesh path's host-numpy inputs; free it once on device
        lanes_np = nmask_np = None
    h, p = h0, h0
    h2, p2 = h0b, h0b
    # pending links in ROW space (merged elementwise each round, flushed to
    # the global arrays at segment end — keeps the hot loop scatter-free);
    # numpy so the first jit call places them per the mesh layout
    succ_l = np.full((n_pad,), -1, dtype=np.int32)
    ovl_l = np.zeros((n_pad,), dtype=np.int32)
    n_loc = n_pad if mesh is None else n_pad // D   # per-device table size
    iters = int(L * coef)

    i = 1
    seg_idx = 0
    pending = None  # count futures of the PREVIOUS segment
    import time as _time

    seg_t0 = _time.time()
    while i < iters:
        seg = _SEG_PLAN[seg_idx] if seg_idx < len(_SEG_PLAN) else _SEG_TAIL
        seg_idx += 1
        if n_loc <= 32768:
            # small table: rounds are ~dispatch-latency-bound and further
            # compaction cannot win it back — run to the end, one segment,
            # no more count round-trips
            seg = iters - i
        i1 = min(i + seg, iters)
        # under shard_map the round program sees per-device blocks
        seg_fn = _cached("seg", _build_seg_fn, n_loc,
                         L, has_n, n_pad, mesh if mesh is not None else None)
        (h, p, h2, p2, a_s, a_p, succ_l, ovl_l, succ_g, ovl_g,
         n_act, n_act_max, n_suf, n_pref) = seg_fn(
            lanes_d, nmask_d, ids, h, p, h2, p2, a_s, a_p,
            succ_l, ovl_l, succ_g, ovl_g, jnp.int32(i), jnp.int32(i1),
        )
        i = i1
        if i >= iters:
            break
        # read the PREVIOUS segment's counts: the readback overlaps with the
        # segment just dispatched (dispatch is async), so the host never
        # stalls on a fresh count round-trip; compaction runs one segment
        # late with counts that are only ever over-estimates — safe
        if pending is not None:
            cnt, cnt_max, csuf, cpref = (int(v) for v in jax.device_get(pending))
            if csuf == 0 or cpref == 0:
                break  # nothing left to match — remaining rounds are no-ops
            # per-device ladder size (the pmax count under mesh keeps the
            # skewed shard's actives; tables stay uniform across devices)
            n_new = _ladder_size(cnt if mesh is None else cnt_max)
            if n_new < n_loc:
                # compaction changes only row placement, never link choices
                # (all decisions are in global-id space), and every dropped
                # row's links were flushed at the last segment end
                compact_fn = _cached("compact", _build_compact_fn, n_loc,
                                     n_new, L, has_n,
                                     mesh if mesh is not None else None)
                (lanes_d, nmask_d, ids, h, p, h2, p2, a_s, a_p,
                 succ_l, ovl_l) = compact_fn(
                    lanes_d, nmask_d, ids, h, p, h2, p2, a_s, a_p,
                    succ_l, ovl_l
                )
                n_loc = n_new
        pending = (n_act, n_act_max, n_suf, n_pref)

    from ..utils import trace as _trace

    if _trace.enabled():
        import time as _time

        print(f"[trace] sweep segments n={n}: {_time.time() - seg_t0:.3f}s",
              flush=True)
    with span(f"sweep readback n={n}"):
        if n_pad < (1 << 24) and L <= 255 and mesh is None:
            # halve the readback bytes: (succ+1, ovl) pack into one u32
            key = ("pk", n_pad)
            if key not in _FN_CACHE:
                _FN_CACHE[key] = jax.jit(
                    lambda s, o: ((s + 1).astype(jnp.uint32) << jnp.uint32(8))
                    | o.astype(jnp.uint32))
            packed_so = jax.device_get(_FN_CACHE[key](succ_g, ovl_g))
            succ_h = (packed_so >> np.uint32(8)).astype(np.int32) - 1
            ovl_h = (packed_so & np.uint32(0xFF)).astype(np.int32)
        else:
            succ_h, ovl_h = jax.device_get((succ_g, ovl_g))
    res = OverlapResult(succ_h[:n].copy(), ovl_h[:n].copy(), L)
    with span("sweep verify_links"):
        _verify_links(res, codes)
    return res


def _verify_links(res: OverlapResult, codes: np.ndarray) -> None:
    """One exact host-side verification of the final links (in place).

    Round pairing (and init duplicate-linking) accepts on two independent
    64-bit hash matches; this pass compares the actual overlap bytes and
    cuts any link that fails, so even a double hash collision costs only a
    dropped link (a slightly longer pg), never a wrong pseudogenome byte.
    Vectorized per overlap length, including the overlap-L duplicates."""
    L = res.read_len
    has = np.nonzero(res.succ >= 0)[0]
    if not has.size:
        return
    ovl = res.overlap[has]
    chunk = 1 << 20  # bound the [rows, o] gather temporaries (~200 MB)
    for o in np.unique(ovl):
        rows_all = has[ovl == o]
        for lo in range(0, rows_all.size, chunk):
            rows = rows_all[lo : lo + chunk]
            bad = (codes[rows, L - o:] != codes[res.succ[rows], :o]).any(axis=1)
            if bad.any():
                cut = rows[bad]
                res.succ[cut] = -1
                res.overlap[cut] = 0


def _bucket_size(n: int) -> int:
    """Round N up to the next {2^k, 1.5*2^k} step (>=256): one compiled
    round program per (bucket, L), persisted in the compilation cache.
    Padding rows are inert; the 1.5 half-steps cut the worst-case pad
    waste from 2x to 1.33x — per-round sort cost AND the table upload
    scale with the padded size, so the finer series pays for its extra
    one-time compiles."""
    b = 256
    while True:
        if n <= b:
            return b
        if n <= b + b // 2:
            return b + b // 2
        b *= 2


def _ladder_size(n: int) -> int:
    """Round N up to the next {2^k, 1.5*2^k} step (>= _COMPACT_FLOOR):
    compaction targets. The shared ladder keeps the set of compiled
    (seg, compact) shapes bounded and IDENTICAL across input scales and
    stages, so the persistent compilation cache absorbs them once per
    machine: when every input size minted its own shape trail, compile
    time dominated large-input wall time (compile cost on the H100 is not
    measured)."""
    return max(_bucket_size(n), _COMPACT_FLOOR)


# ---------------------------------------------------------------------------
# host post-processing (numpy pointer doubling)
# ---------------------------------------------------------------------------


def both_sides_overlapped(res: OverlapResult) -> np.ndarray:
    """HQ filter (reference getBothSidesOverlappedReads,
    AbstractOverlapPseudoGenomeGenerator.cpp:67-98): keep reads overlapped on
    both sides, or duplicate-linked on either side."""
    n = res.succ.shape[0]
    L = res.read_len
    prev_overlap = np.zeros(n, dtype=np.int32)
    has = res.succ >= 0
    prev_overlap[res.succ[has]] = res.overlap[has]
    keep = ((prev_overlap > 0) & has) | (has & (res.overlap == L)) | (prev_overlap == L)
    return keep


def remove_cycles(res: OverlapResult) -> None:
    """Cut the minimum-overlap edge of every cycle (in place).

    Functional-graph cycles are found with pointer doubling; per cycle the
    edge with minimal (overlap, node) is removed — same effect as the
    reference's sequential walk (AbstractOverlap...cpp:6-41).
    """
    n = res.succ.shape[0]
    if n == 0:
        return
    f = res.succ.astype(np.int64).copy()
    terminal = f < 0
    f[terminal] = np.nonzero(terminal)[0]
    reaches_terminal = terminal.copy()
    # min node id reachable (propagated along the walk) for cycle ids
    mmin = np.arange(n, dtype=np.int64)
    steps = 1
    while steps < 2 * n:
        reaches_terminal |= reaches_terminal[f]
        mmin = np.minimum(mmin, mmin[f])
        f = f[f]
        steps *= 2
    in_cycle = ~reaches_terminal
    if not in_cycle.any():
        return
    cyc_nodes = np.nonzero(in_cycle)[0]
    cyc_id = mmin[cyc_nodes]  # min node of each cycle
    # pick per cycle the node with min (overlap, node) and cut its edge
    order = np.lexsort((cyc_nodes, res.overlap[cyc_nodes], cyc_id))
    sorted_ids = cyc_id[order]
    first_of_group = np.ones(sorted_ids.size, dtype=bool)
    first_of_group[1:] = sorted_ids[1:] != sorted_ids[:-1]
    cut = cyc_nodes[order[first_of_group]]
    res.succ[cut] = -1
    res.overlap[cut] = 0


@dataclass
class ChainLayout:
    order: np.ndarray       # [N] read indexes in pseudogenome order
    pos: np.ndarray         # [N] pg position per read (aligned with `order`? no: per read idx)
    pg_len: int


def layout_chains(res: OverlapResult) -> ChainLayout:
    """Compute each read's pseudogenome position via pointer doubling.

    Chains are laid out consecutively in increasing head-read order
    (mirroring the reference's head-order assembly); within a chain read x
    sits at head_start + sum(L - overlap) over its predecessors. Duplicate
    reads share positions; the reads-list order is (pos, rank-in-chain).
    """
    succ = res.succ
    n = succ.shape[0]
    L = res.read_len
    if n == 0:
        return ChainLayout(np.zeros(0, np.int64), np.zeros(0, np.int64), 0)
    pred = np.full(n, -1, dtype=np.int64)
    has = succ >= 0
    pred[succ[has]] = np.nonzero(has)[0]

    g = pred.copy()
    heads = g < 0
    g[heads] = np.nonzero(heads)[0]
    # weight of edge pred->x = L - overlap[pred[x]]
    w = np.zeros(n, dtype=np.int64)
    nz = pred >= 0
    w[nz] = L - res.overlap[pred[nz]]
    rank = nz.astype(np.int64)
    steps = 1
    while steps < 2 * n:
        w = w + w[g]
        rank = rank + rank[g]
        g = g[g]
        steps *= 2
    head = g  # chain head per read
    # chain length = max local offset + L, per head
    chain_end = np.zeros(n, dtype=np.int64)
    np.maximum.at(chain_end, head, w + L)
    head_ids = np.nonzero(heads)[0]
    lengths = chain_end[head_ids]
    starts = np.zeros(head_ids.size, dtype=np.int64)
    starts[1:] = np.cumsum(lengths)[:-1]
    start_per_head = np.zeros(n, dtype=np.int64)
    start_per_head[head_ids] = starts
    pos = start_per_head[head] + w
    pg_len = int(lengths.sum())
    order = np.lexsort((rank, pos))
    return ChainLayout(order=order.astype(np.int64), pos=pos, pg_len=pg_len)


def assemble_pg(codes: np.ndarray, layout: ChainLayout) -> np.ndarray:
    """Materialise the pseudogenome sequence: every read scatters its full
    content at its position (overlapping bytes agree by construction)."""
    n, L = codes.shape
    pg = np.zeros(layout.pg_len, dtype=np.uint8)
    if n == 0:
        return pg
    flat = (layout.pos[:, None] + np.arange(L, dtype=np.int64)[None, :]).ravel()
    pg[flat] = codes.ravel()
    return pg


def _layout_and_assemble(res: OverlapResult, codes: np.ndarray):
    """Chain layout + pg materialisation for a final link set.

    Normally one sequential native pass (native/chainwalk.cpp — the
    reference's chain-walk assembly, AbstractOverlapPseudoGenomeGenerator
    .cpp:181-219); the numpy pointer-doubling path is the semantic
    reference and fallback."""
    if res.succ.size:
        from .. import native

        fast = native.chain_walk_assemble(res.succ, res.overlap, codes)
        if fast is not None:
            pos, order, pg = fast
            return pg, order.astype(np.int64), pos[order]
    remove_cycles(res)
    layout = layout_chains(res)
    pg = assemble_pg(codes, layout)
    return pg, layout.order, layout.pos[layout.order]


def generate_pseudogenome(codes: np.ndarray, coef: float = 1.0, mesh=None):
    """Full pipeline: overlaps -> cycle removal -> layout -> pg sequence.

    Returns (pg_codes, order, pos_sorted) where order is the reads-list
    (pg-order) permutation of read indexes and pos_sorted their positions.
    """
    res = find_overlaps(codes, coef, mesh=mesh)
    return _layout_and_assemble(res, codes)


def _find_overlaps_partitioned(codes: np.ndarray, coef: float,
                               mesh=None) -> OverlapResult:
    """Oversized inputs: sweep row parts independently, then repair across
    parts (only free suffix/prefix ends active). Links stay exact-verified;
    tie-breaks inside each part are part-local — the result is a valid
    (slightly less greedy-optimal) link set, like the reference's
    block-parallel generator accepts block-local orders
    (ParallelGreedySwiping...cpp:146-210)."""
    n, L = codes.shape
    parts = -(-n // _SWEEP_MAX_ROWS)
    per = -(-n // parts)
    res = OverlapResult(np.full(n, -1, dtype=np.int32),
                        np.zeros(n, dtype=np.int32), L)
    from ..utils.trace import span

    for p in range(parts):
        lo, hi = p * per, min((p + 1) * per, n)
        with span(f"sweep part {p + 1}/{parts} rows={hi - lo}"):
            sub = find_overlaps(codes[lo:hi], coef=coef, mesh=mesh)
        has = sub.succ >= 0
        res.succ[lo:hi][has] = sub.succ[has] + np.int32(lo)
        res.overlap[lo:hi][has] = sub.overlap[has]
    with span("sweep cross-part repair"):
        repair_links(codes, res, mesh=mesh, coef=coef)
    return res


def repair_links(codes: np.ndarray, res: OverlapResult, mesh=None,
                 coef: float = 1.0) -> None:
    """Re-match the free suffix/prefix ends of a link set (in place).

    Runs a compacted sweep in which ONLY rows without a successor (suffix
    side) / without a predecessor (prefix side) are active — used after
    divide_and_generate cuts the links that touched dropped reads. New
    links merge into `res`."""
    n = res.succ.shape[0]
    if n <= 1:
        return
    has_pred = np.zeros(n, dtype=bool)
    s = res.succ
    has_pred[s[s >= 0]] = True
    a_s = s < 0
    a_p = ~has_pred
    rows = np.nonzero(a_s | a_p)[0]
    if rows.size <= 1:
        return
    # a repair set larger than the device table cap repairs in parts
    # (cross-part misses stay free ends — a bounded greedy loss)
    for lo in range(0, rows.size, _SWEEP_MAX_ROWS):
        r = rows[lo : lo + _SWEEP_MAX_ROWS]
        sub = find_overlaps(codes[r], coef=coef, mesh=mesh,
                            init_active=(a_s[r], a_p[r]))
        new = sub.succ >= 0
        res.succ[r[new]] = r[sub.succ[new]].astype(np.int32)
        res.overlap[r[new]] = sub.overlap[new]


def divide_and_generate(codes: np.ndarray, coef: float, mesh=None):
    """Fused stages 2+3: ONE full-depth sweep serves both the generator-
    based division and hq pg generation.

    The division's partial run is a prefix of the full sweep's rounds, and
    links never change once formed — so the partial run's link set is
    EXACTLY the full sweep's links with overlap >= L - int(L*coef) + 1,
    and `keep` equals the two-run pipeline's division bit-for-bit. Links
    touching dropped reads are then cut and the freed ends re-matched by a
    small repair sweep (only they are active), replacing the reference's
    full second generator run (pgrc-encoder.cpp:286-341: two complete
    findOverlappingReads executions sharing nothing).

    Returns (keep_mask [n], pg, order, pos) — order/pos in kept-row space.
    """
    from ..utils.trace import span

    n, L = codes.shape
    with span(f"fused full sweep n={n}"):
        resf = find_overlaps(codes, coef=1.0, mesh=mesh)
    iters = int(L * coef)
    thr = L - iters + 1  # minimum overlap reachable by rounds [1, iters)
    part = resf.overlap >= thr
    snap = OverlapResult(
        np.where(part, resf.succ, -1).astype(np.int32),
        np.where(part, resf.overlap, 0).astype(np.int32), L)
    keep = both_sides_overlapped(snap)
    kept = np.nonzero(keep)[0]
    remap = np.full(n, -1, dtype=np.int64)
    remap[kept] = np.arange(kept.size)
    sk = np.clip(resf.succ[kept], 0, max(n - 1, 0))
    good = (resf.succ[kept] >= 0) & keep[sk]
    # weak-link re-cut: low-overlap links formed in late rounds under
    # dropped-read competition; cutting the weakest few % and letting the
    # repair sweep relink them at full depth recovers most of the two-run
    # pipeline's pg length (measured at 200k: +1.64% -> +0.2% for an 8%
    # cut budget) while the repair table stays small
    ovl_k = resf.overlap[kept]
    budget = int(0.08 * kept.size)
    hist = np.bincount(np.where(good, np.minimum(ovl_k, L), L),
                       minlength=L + 1)
    csum = np.cumsum(hist)  # csum[t-1] = count of good links with ovl < t
    relink_thr = 0
    for t in range(min(75, L - 1), thr, -1):
        if csum[t - 1] <= budget:
            relink_thr = t
            break
    if relink_thr:
        good = good & (ovl_k >= relink_thr)
    res_k = OverlapResult(
        np.where(good, remap[sk], -1).astype(np.int32),
        np.where(good, ovl_k, 0).astype(np.int32), L)
    sub_codes = codes[kept]
    with span(f"repair sweep kept={kept.size}"):
        repair_links(sub_codes, res_k, mesh=mesh)
    with span("chainwalk+assemble"):
        pg, order, pos = _layout_and_assemble(res_k, sub_codes)
    return keep, pg, order, pos
