"""Benchmark: compression throughput + ratio on a synthetic WGS-like FASTQ.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

The headline metric is SE compression throughput in input Mbases/s on the
default (SE, NORMAL level) configuration at PGRC_BENCH_READS reads. Extra
fields cover the other archive modes (PE, SE_ORD), a 10x scaling point
(PGRC_BENCH_SCALE_READS, encode+decode), peak RSS, and a hard
bits-per-base gate: if the SE ratio regresses past the reference's
0.1412 bits/base the whole bench reports failure — the won compression
axis cannot silently regress while chasing throughput.

vs_baseline compares against the reference PgRC binary when one has been
built at build-ref/PgRC (see bench_ref.sh); otherwise against a recorded
8-thread CPU figure from this machine (BASELINE_LOCAL, measured once and
updated when bench_ref runs).

Only one process opens the device at a time: this parent never imports
JAX and runs the device work in child processes, one after another (a JAX
process on a GPU reserves most of the card's memory, so a second one
would fail for want of it). Every row names the device JAX reported and,
where nvidia-smi exists, each card's name and power limit.
"""
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

# bases/s of the reference PgRC binary with -t 8 on this machine's CPU;
# refreshed by bench_ref.sh (stored in build-ref/baseline.json when present)
BASELINE_LOCAL_MBASES_S = 2.2
REFERENCE_BITS_PER_BASE = 0.1412  # reference archive on the 200k config


_SYNTH_CHUNK = 1 << 20   # reads generated and written per block
_ID_DIGITS = 9           # fixed-width read ids: "@r000000042"


def _fastq_records(codes, lowq, first_id):
    """Vectorized FASTQ records (fixed-width header, 'I' qualities with the
    second half '#' on low-quality reads) as one bytes block."""
    from pgrc.utils import dna

    n, L = codes.shape
    q0 = 2 + _ID_DIGITS + 1 + L + 1 + 2   # first quality byte
    buf = np.empty((n, q0 + L + 1), dtype=np.uint8)
    buf[:, 0] = ord("@")
    buf[:, 1] = ord("r")
    ids = np.arange(first_id, first_id + n, dtype=np.int64)
    for d in range(_ID_DIGITS):
        buf[:, 2 + d] = (ids // 10 ** (_ID_DIGITS - 1 - d)) % 10 + ord("0")
    s0 = 2 + _ID_DIGITS + 1
    buf[:, s0 - 1] = 10
    buf[:, s0 : s0 + L] = dna.VAL2SYM[codes]
    buf[:, s0 + L] = 10
    buf[:, s0 + L + 1] = ord("+")
    buf[:, s0 + L + 2] = 10
    buf[:, q0 : q0 + L] = ord("I")
    buf[lowq, q0 + L // 2 : q0 + L] = ord("#")
    buf[:, q0 + L] = 10
    return buf.tobytes()


def synth_fastq(path, n_reads, read_len, genome_len, seed=0, pair=None,
                repeats=False):
    """Synthetic WGS-like FASTQ; with `pair`, writes a mate file whose reads
    are sampled nearby on the genome (insert ~300) for PE benching.

    With `repeats`, the genome gets realistic repeat structure instead of
    uniform randomness: ~45% of it is built from a 300 bp ALU-like element
    and a 6 kb LINE-like element re-inserted many times at 5-15% divergence,
    plus short tandem repeats — the regime that stresses k-mer bucket
    truncation, the rescue pass, and pg self-matching.

    Reads are made and written in blocks of _SYNTH_CHUNK with vectorized
    record formatting, so a 10M-read file costs seconds and ~1 GB beside
    the returned code matrix (the first file's reads, [n_reads, L] u8)."""
    from pgrc.utils import dna

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    if repeats:
        def insert(elem, copies, divergence):
            for _ in range(copies):
                e = elem.copy()
                mut = rng.random(e.size) < divergence
                e[mut] = (e[mut] + rng.integers(1, 4, size=int(mut.sum()))) % 4
                at = rng.integers(0, genome_len - e.size)
                genome[at : at + e.size] = e

        alu = rng.integers(0, 4, size=300, dtype=np.uint8)
        line = rng.integers(0, 4, size=6000, dtype=np.uint8)
        insert(alu, max(genome_len // 1000, 4), 0.10)    # ~30% ALU-like
        insert(line, max(genome_len // 50_000, 2), 0.05)  # ~12% LINE-like
        tandem = np.tile(rng.integers(0, 4, size=4, dtype=np.uint8),
                         rng.integers(20, 80))
        insert(tandem, max(genome_len // 40_000, 2), 0.02)
    starts = rng.integers(0, genome_len - read_len, size=n_reads)

    def make(starts, path):
        out = np.empty((n_reads, read_len), dtype=np.uint8)
        with open(path, "wb") as f:
            for lo in range(0, n_reads, _SYNTH_CHUNK):
                hi = min(lo + _SYNTH_CHUNK, n_reads)
                codes = genome[starts[lo:hi, None]
                               + np.arange(read_len)[None, :]]
                flip = rng.random(hi - lo) < 0.5
                codes[flip] = dna.COMPL_VAL[codes[flip][:, ::-1]]
                err = rng.random(codes.shape) < 0.004
                codes[err] = (codes[err]
                              + rng.integers(1, 4, size=int(err.sum()))) % 4
                lowq = rng.random(hi - lo) < 0.12
                f.write(_fastq_records(codes, lowq, lo))
                out[lo:hi] = codes
        return out

    codes = make(starts, path)
    if pair:
        mate_starts = np.clip(starts + rng.integers(150, 450, size=n_reads),
                              0, genome_len - read_len)
        make(mate_starts, pair)
    return codes


def bench_dir() -> str:
    """Directory for bench inputs and archives: $PGRC_BENCH_TMP, else the
    checkout's own git-ignored bench_data/, so two checkouts never read or
    overwrite each other's inputs."""
    path = os.environ.get("PGRC_BENCH_TMP") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "bench_data")
    os.makedirs(path, exist_ok=True)
    return path


def read_baseline():
    p = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "build-ref", "baseline.json")
    if os.path.exists(p):
        try:
            with open(p) as f:
                return float(json.load(f)["mbases_per_s"])
        except Exception:
            pass
    return BASELINE_LOCAL_MBASES_S


def _encode(encoder, PgRCParams, src, out, **kw):
    t0 = time.time()
    stats = encoder.encode(PgRCParams(src_fastq=src, output=out, **kw))
    return stats, time.time() - t0


def fail(msg):
    print(json.dumps({"metric": "compression_throughput", "value": 0.0,
                      "unit": "Mbases/s", "vs_baseline": 0.0, "error": msg}))
    return 1


def _child(*args):
    """Run one phase of the bench in a child process; its last stdout line
    is a JSON object."""
    import subprocess

    p = subprocess.run([sys.executable, os.path.abspath(__file__), *args],
                       capture_output=True, text=True)
    try:
        return json.loads(p.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        return {"error": f"{args[0]} child failed: {p.stderr[-300:]}"}


def main():
    from pgrc.device import gpu_name_and_power_limit

    gpu = gpu_name_and_power_limit() or "not available"
    n_reads = int(os.environ.get("PGRC_BENCH_READS", 200_000))
    n_scale = int(os.environ.get("PGRC_BENCH_SCALE_READS", 10 * n_reads))
    read_len = 100
    tmpdir = bench_dir()

    rows = _child("--rows")
    if rows.get("error"):
        return fail(rows["error"])
    mbases_s = rows["value"]
    extra = {}

    # --- 10M-read row (gated): cold + warm encode, STREAMING validate,
    # peak-RSS budget. Each phase runs in its own child process so its
    # peak RSS is its own. PGRC_BENCH_BIG=0 disables. ---
    n_big = int(os.environ.get("PGRC_BENCH_BIG_READS", 10_000_000))
    if os.environ.get("PGRC_BENCH_BIG", "1") != "0" and n_big > n_scale:
        src_b = os.path.join(tmpdir, f"bench_{n_big}.fastq")
        if not os.path.exists(src_b):
            synth_fastq(src_b, n_big, read_len, n_big * read_len // 40, seed=9)
        out_b = os.path.join(tmpdir, "bench_big.pgtc")
        big = {}
        for phase in ("cold", "warm", "validate"):
            big[phase] = _child("--big-row", phase, src_b, out_b)
            if big[phase].get("error"):
                return fail(f"{n_big}-read {phase}: {big[phase]['error']}")
        b_bases = n_big * read_len
        extra["big_reads"] = n_big
        extra["big_mbases_s"] = round(b_bases / 1e6 / big["warm"]["wall_s"], 3)
        extra["big_cold_mbases_s"] = round(
            b_bases / 1e6 / big["cold"]["wall_s"], 3)
        extra["big_bits_per_base"] = big["warm"]["bits_per_base"]
        extra["big_peak_rss_mb"] = big["warm"]["peak_rss_mb"]
        extra["big_validate_rss_mb"] = big["validate"]["peak_rss_mb"]
        extra["big_device"] = big["warm"]["device"]
        # memory gates: bounded-memory encode AND streaming validation
        if big["warm"]["peak_rss_mb"] > 6144:
            return fail(f"{n_big}-read peak RSS "
                        f"{big['warm']['peak_rss_mb']} MB exceeds 6 GB")
        # the streaming validator measured 1.07 GB standalone on a 10M
        # archive but ~3.6 GB inside a bench run (unexplained); 4 GB still
        # catches a return of the whole-matrix validate (~10 GB at 10M)
        if big["validate"]["peak_rss_mb"] > 4096:
            return fail(f"{n_big}-read validate RSS "
                        f"{big['validate']['peak_rss_mb']} MB exceeds 4 GB")
        # scaling gate vs the 200k row of the SAME bench run: catches a
        # scale collapse (the 10M point is expected near 0.5x the 200k one)
        if extra["big_mbases_s"] < 0.4 * mbases_s:
            return fail(f"{n_big}-read throughput {extra['big_mbases_s']} "
                        f"fell below 0.4x the {n_reads}-read point "
                        f"({mbases_s:.2f})")

    # throughput-scaling gate: large inputs must not fall behind the 200k
    # point (both rows hold medians of 3)
    if "scale_mbases_s" in rows and rows["scale_mbases_s"] < 0.8 * mbases_s:
        return fail(f"scale throughput {rows['scale_mbases_s']} fell below "
                    f"0.8x the {n_reads}-read point ({mbases_s:.2f})")
    # memory gate: bounded-memory operation at scale
    if rows["peak_rss_mb"] > 6144 and n_scale <= 2_000_000:
        return fail(f"peak RSS {rows['peak_rss_mb']} MB exceeds 6 GB budget")

    baseline = read_baseline()
    # vs_baseline floor: a throughput collapse against the reference CPU
    # binary is a hard failure, not a statistic
    if n_reads >= 100_000 and mbases_s / baseline < 0.7:
        return fail(f"vs_baseline {mbases_s / baseline:.3f} fell below the "
                    f"0.7 floor (median of 3 runs: {rows['run_spread_s']})")
    result = {**rows, "vs_baseline": round(mbases_s / baseline, 3),
              "gpu": gpu, **extra}
    print(json.dumps(result))
    return 0


def rows() -> int:
    """Child process: every row but the 10M one, as one JSON line."""
    from pgrc.device import describe

    n_reads = int(os.environ.get("PGRC_BENCH_READS", 200_000))
    n_scale = int(os.environ.get("PGRC_BENCH_SCALE_READS", 10 * n_reads))
    read_len = 100
    tmpdir = bench_dir()
    src = os.path.join(tmpdir, f"bench_{n_reads}.fastq")
    pair = os.path.join(tmpdir, f"bench_{n_reads}_2.fastq")
    if not (os.path.exists(src) and os.path.exists(pair)):
        synth_fastq(src, n_reads, read_len,
                    max(n_reads * read_len // 40, 200_000), seed=7, pair=pair)

    from pgrc.archive import encoder, decoder
    from pgrc.config import PgRCParams

    out = os.path.join(tmpdir, "bench.pgtc")
    # warm-up: full encode of the SAME input so every device program for the
    # measured shapes is compiled (and lands in the persistent cache) before
    # the timed run — jit programs are shape-bucketed, so a smaller warm-up
    # input would compile different programs
    _, cold_dt0 = _encode(encoder, PgRCParams, src, os.path.join(tmpdir, "w.pgtc"))

    # median of 3 timed encodes, so a real regression cannot hide inside
    # run-to-run noise — the gates hold the MEDIAN
    runs = []
    for _i in range(3):
        stats, dt = _encode(encoder, PgRCParams, src, out)
        runs.append(dt)
    runs.sort()
    dt = runs[1]
    bases = stats.reads_total * stats.read_len
    mbases_s = bases / 1e6 / dt
    bits_per_base = stats.archive_bytes * 8 / bases

    t0 = time.time()
    n_out = decoder.decode_to_files(out, os.path.join(tmpdir, "bench_dec"))
    dec_dt = time.time() - t0

    # correctness gate: the archive must round-trip
    rep = decoder.validate(out, src)
    if rep["errors"] or n_out != stats.reads_total:
        return fail("round-trip failed")
    # ratio-regression gate: the compression win is load-bearing (the
    # reference figure is for the standard ~40x-coverage 200k config, so
    # only gate at representative sizes)
    if n_reads >= 100_000 and bits_per_base > REFERENCE_BITS_PER_BASE:
        return fail(f"bits_per_base {bits_per_base:.4f} regressed past "
                    f"reference {REFERENCE_BITS_PER_BASE}")

    extra = {}
    # --- PE mode row (cold = pays one-time compiles for PE's shapes) ---
    pe_out = os.path.join(tmpdir, "bench_pe.pgtc")
    _, pe_cold = _encode(encoder, PgRCParams, src, pe_out, pair_fastq=pair)
    pstats, pdt = _encode(encoder, PgRCParams, src, pe_out, pair_fastq=pair)
    pe_bases = pstats.reads_total * pstats.read_len
    if decoder.validate(pe_out, src, pair)["errors"]:
        return fail("PE round-trip failed")
    extra["pe_mbases_s"] = round(pe_bases / 1e6 / pdt, 3)
    extra["pe_cold_mbases_s"] = round(pe_bases / 1e6 / pe_cold, 3)
    extra["pe_bits_per_base"] = round(pstats.archive_bytes * 8 / pe_bases, 4)

    # --- SE_ORD row ---
    ord_out = os.path.join(tmpdir, "bench_ord.pgtc")
    ostats, odt = _encode(encoder, PgRCParams, src, ord_out,
                          preserve_order=True)
    if decoder.validate(ord_out, src)["errors"]:
        return fail("SE_ORD round-trip failed")
    extra["se_ord_mbases_s"] = round(bases / 1e6 / odt, 3)
    extra["se_ord_bits_per_base"] = round(ostats.archive_bytes * 8 / bases, 4)

    # --- repeat-structured data row (realistic repeat landscape; stresses
    # bucket truncation / rescue / pg self-matching in ways uniform-random
    # genomes never do) ---
    rep_src = os.path.join(tmpdir, f"bench_rep_{n_reads}.fastq")
    if not os.path.exists(rep_src):
        synth_fastq(rep_src, n_reads, read_len,
                    max(n_reads * read_len // 40, 200_000), seed=11,
                    repeats=True)
    rep_out = os.path.join(tmpdir, "bench_rep.pgtc")
    rstats, rdt = _encode(encoder, PgRCParams, rep_src, rep_out)
    if decoder.validate(rep_out, rep_src)["errors"]:
        return fail("repeat-data round-trip failed")
    extra["repeat_mbases_s"] = round(bases / 1e6 / rdt, 3)
    extra["repeat_bits_per_base"] = round(rstats.archive_bytes * 8 / bases, 4)
    extra["repeat_matched_frac"] = round(
        rstats.matched_count
        / max(rstats.reads_total - rstats.hq_count + rstats.matched_count, 1), 4)

    # --- scaling rows (10x and optionally 50x reads): encode twice — the
    # first pass pays one-time XLA compiles for any shapes this machine has
    # never seen (persisted to the compilation cache), the second measures
    # steady-state throughput. Both are reported; the gate below holds the
    # WARM number, since compile cost is a per-machine constant while encode
    # cost scales with input (the reference's analog: its first run also
    # pays one-time OS page-cache/index warmup, just far less of it). ---
    for label, n_s in (("scale", n_scale),
                       ("scale2", int(os.environ.get("PGRC_BENCH_SCALE2_READS", 0)))):
        if n_s <= n_reads:
            continue
        src_s = os.path.join(tmpdir, f"bench_{n_s}.fastq")
        if not os.path.exists(src_s):
            synth_fastq(src_s, n_s, read_len,
                        max(n_s * read_len // 40, 200_000), seed=9)
        out_s = os.path.join(tmpdir, "bench_scale.pgtc")
        _, cold_dt = _encode(encoder, PgRCParams, src_s, out_s)
        s_runs = []
        for _i in range(3):
            sstats, s_dt_i = _encode(encoder, PgRCParams, src_s, out_s)
            s_runs.append(s_dt_i)
        s_runs.sort()
        sdt = s_runs[1]
        s_bases = sstats.reads_total * sstats.read_len
        t0 = time.time()
        decoder.decode_to_files(out_s, os.path.join(tmpdir, "bench_scale_dec"))
        s_dec = time.time() - t0
        extra[f"{label}_reads"] = n_s
        extra[f"{label}_run_spread_s"] = [round(r, 3) for r in s_runs]
        extra[f"{label}_mbases_s"] = round(s_bases / 1e6 / sdt, 3)
        extra[f"{label}_cold_mbases_s"] = round(s_bases / 1e6 / cold_dt, 3)
        extra[f"{label}_bits_per_base"] = round(sstats.archive_bytes * 8 / s_bases, 4)
        extra[f"{label}_decomp_mbases_s"] = round(s_bases / 1e6 / s_dec, 3)

    result = {
        "metric": "compression_throughput",
        "value": round(mbases_s, 3),
        "unit": "Mbases/s",
        "device": describe(),
        "bits_per_base": round(bits_per_base, 4),
        "archive_bytes": stats.archive_bytes,
        "reads": stats.reads_total,
        "cold_mbases_s": round(bases / 1e6 / cold_dt0, 3),
        "run_spread_s": [round(r, 3) for r in runs],
        "decomp_mbases_s": round(bases / 1e6 / dec_dt, 3),
        "stage_times_s": {k: round(v, 2) for k, v in stats.stage_times.items()},
        "peak_rss_mb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1),
        **extra,
    }
    print(json.dumps(result))
    return 0


def big_row(phase: str, src_b: str, out_b: str) -> int:
    """Child process for one phase of the gated big row ('cold'/'warm'
    encode or 'validate'), reporting ITS OWN wall time + peak RSS as one
    JSON line — each phase gets clean memory accounting."""
    from pgrc.device import describe

    try:
        t0 = time.time()
        res = {}
        if phase in ("cold", "warm"):
            from pgrc.archive import encoder
            from pgrc.config import PgRCParams

            bstats, wall = _encode(encoder, PgRCParams, src_b, out_b)
            b_bases = bstats.reads_total * bstats.read_len
            res["bits_per_base"] = round(bstats.archive_bytes * 8 / b_bases, 4)
            res["wall_s"] = round(wall, 1)
            res["device"] = describe()
        else:
            from pgrc.archive import decoder

            print(f"[big-row] validating {out_b} ({os.path.getsize(out_b)} B)"
                  f" vs {src_b}", file=sys.stderr)
            rep = decoder.validate(out_b, src_b)
            if rep["errors"]:
                print(json.dumps({"error": "round-trip failed"}))
                return 1
            res["wall_s"] = round(time.time() - t0, 1)
            res["reads"] = rep["reads"]
        res["peak_rss_mb"] = round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1)
        print(json.dumps(res))
        return 0
    except Exception as e:  # surfaced as a bench failure by the parent
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
        return 1


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--big-row":
        sys.exit(big_row(sys.argv[2], sys.argv[3], sys.argv[4]))
    if len(sys.argv) == 2 and sys.argv[1] == "--rows":
        sys.exit(rows())
    sys.exit(main())
