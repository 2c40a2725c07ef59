"""Smoke test of the compressor on an NVIDIA GPU.

    python chip_smoke.py              # one GPU: every phase below but the mesh
    python chip_smoke.py --chips 4    # four GPUs: only the 4-device mesh phase

One process drives the card through the entry points a user calls:

  * a 10M-read x 100 bp single-end run at 40x synthetic coverage, compressed,
    decompressed and validated through `pgrc.cli.main`;
  * the other archive modes at smaller sizes (PE 2x1M, SE_ORD 1M with -o,
    PE_ORD 2x200k), so every device program variant compiles and runs;
  * exact comparisons with the plain references: the archive built on the
    GPU must equal, byte for byte, the one built in the same process on the
    CPU backend, and the device overlap sweep must equal its numpy mirror
    (all device math is integer, so equality is the only tolerance).

A round trip is correct when the decoded reads equal the input's exactly:
byte-identical files in the order-preserving modes, equal sorted read
matrices otherwise (PE compared as joined pair rows). The streaming
validator's summed line hashes are not relied on.

Prints the devices as JAX reports them, each card's name and power limit as
nvidia-smi gives them, one line per phase, and as its last line one JSON
object {"ok": true, "device": {...}}. Exits non-zero without that line when
JAX finds no GPU or any phase fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from pgrc import device, native  # noqa: E402

READ_LEN = 100
COVERAGE = 40
SE_READS = 10_000_000
PE_PAIRS = 1_000_000
SE_ORD_READS = 1_000_000
PE_ORD_PAIRS = 200_000
BACKEND_READS = 100_000
MIRROR_READS = 200_000
MESH_READS = 2_000_000
_ROWS_PER_BLOCK = 1 << 20   # bounds the [rows, L] int64 gather indexes


class SmokeFailure(Exception):
    """A phase produced a wrong result."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def synth(work: str, name: str, n: int, seed: int, pair: bool = False):
    """Input FASTQ path(s) of n reads (n pairs with `pair`) at 40x."""
    from bench import synth_fastq

    src = os.path.join(work, f"{name}.fastq")
    mate = os.path.join(work, f"{name}_2.fastq") if pair else None
    synth_fastq(src, n, READ_LEN, max(n * READ_LEN // COVERAGE, 200_000),
                seed=seed, pair=mate)
    return [src] + ([mate] if pair else [])


def seq_lines(path: str) -> np.ndarray:
    """[n, L] u8 matrix of a FASTQ file's sequence lines, parsed with plain
    numpy (independent of the parser under test)."""
    data = np.fromfile(path, dtype=np.uint8)
    nl = np.flatnonzero(data == 10)
    check(nl.size % 4 == 0, f"{path}: line count not a multiple of 4")
    ends = nl[1::4]
    starts = nl[0::4] + 1
    L = int(ends[0] - starts[0])
    check(bool((ends - starts == L).all()), f"{path}: reads of unequal length")
    out = np.empty((starts.size, L), dtype=np.uint8)
    cols = np.arange(L)
    for lo in range(0, starts.size, _ROWS_PER_BLOCK):
        hi = lo + _ROWS_PER_BLOCK
        out[lo:hi] = data[starts[lo:hi, None] + cols]
    return out


def decoded_lines(path: str, read_len: int) -> np.ndarray:
    """[n, L] u8 matrix of a decoded file; checks it is n lines of exactly
    read_len symbols."""
    data = np.fromfile(path, dtype=np.uint8)
    check(data.size % (read_len + 1) == 0, f"{path}: not whole lines")
    rows = data.reshape(-1, read_len + 1)
    check(bool((rows[:, read_len] == 10).all()), f"{path}: ragged lines")
    return rows[:, :read_len]


def sorted_rows(m: np.ndarray) -> np.ndarray:
    """The rows of a u8 matrix as a sorted array of fixed-width strings."""
    m = np.ascontiguousarray(m)
    return np.sort(m.view(f"S{m.shape[1]}").ravel())


def same_reads(want: list, got: list, ordered: bool) -> bool:
    """Exact comparison of input and decoded read matrices (one per file):
    equal in order when `ordered`, else equal as multisets of (pair) rows."""
    if ordered:
        return all(w.shape == g.shape and np.array_equal(w, g)
                   for w, g in zip(want, got))
    w, g = np.hstack(want), np.hstack(got)
    return w.shape == g.shape and np.array_equal(sorted_rows(w),
                                                 sorted_rows(g))


def _remove(*paths: str) -> None:
    for p in paths:
        if os.path.exists(p):
            os.remove(p)


def roundtrip(work: str, name: str, n: int, seed: int, pair: bool = False,
              ordered: bool = False) -> dict:
    """Compress, decompress and validate through the CLI; the decoded reads
    must equal the input's exactly."""
    from pgrc import cli

    inputs = synth(work, name, n, seed, pair)
    archive = os.path.join(work, f"{name}.pgtc")
    t0 = time.perf_counter()
    check(cli.main([*(["-o"] if ordered else []), "-i", *inputs, archive])
          == 0, f"{name}: compress failed")
    t1 = time.perf_counter()
    check(cli.main(["-d", archive]) == 0, f"{name}: decompress failed")
    t2 = time.perf_counter()
    check(cli.main(["-d", "-i", *inputs, archive]) == 0,
          f"{name}: validate failed")
    t3 = time.perf_counter()
    outs = ([archive + "_out_1", archive + "_out_2"] if pair
            else [archive + "_out"])
    ok = same_reads([seq_lines(p) for p in inputs],
                    [decoded_lines(p, READ_LEN) for p in outs], ordered)
    check(ok, f"{name}: decoded reads differ from the input")
    bases = n * READ_LEN * len(inputs)
    res = {"phase": name, "reads": n * len(inputs),
           "compress_s": round(t1 - t0, 3), "decompress_s": round(t2 - t1, 3),
           "validate_s": round(t3 - t2, 3),
           "bits_per_base": round(os.path.getsize(archive) * 8 / bases, 6)}
    _remove(*inputs, archive, *outs)
    return res


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def backend_equality(work: str, n: int = BACKEND_READS) -> dict:
    """The archive built on the default device equals, byte for byte, the
    one built in the same process on the CPU backend."""
    import jax

    from pgrc.archive import encoder
    from pgrc.config import PgRCParams

    (src,) = synth(work, "backend", n, seed=5)
    a_dev = os.path.join(work, "backend_dev.pgtc")
    a_cpu = os.path.join(work, "backend_cpu.pgtc")
    t0 = time.perf_counter()
    encoder.encode(PgRCParams(src_fastq=src, output=a_dev))
    t1 = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        encoder.encode(PgRCParams(src_fastq=src, output=a_cpu))
    t2 = time.perf_counter()
    dev_blob, cpu_blob = _read(a_dev), _read(a_cpu)
    check(dev_blob == cpu_blob,
          f"backend archives differ ({len(dev_blob)} vs {len(cpu_blob)} B)")
    _remove(src, a_dev, a_cpu)
    return {"phase": "backend_equality", "reads": n,
            "archive_bytes": len(dev_blob), "device_s": round(t1 - t0, 3),
            "cpu_backend_s": round(t2 - t1, 3)}


def overlap_mirror(work: str, n: int = MIRROR_READS) -> dict:
    """The device overlap sweep's links equal its numpy mirror's."""
    from bench import synth_fastq
    from pgrc.overlap import greedy_scs

    path = os.path.join(work, "mirror.fastq")
    codes = synth_fastq(path, n, READ_LEN,
                        max(n * READ_LEN // COVERAGE, 200_000), seed=3)
    _remove(path)
    check(n > greedy_scs._HOST_SWEEP_MAX,
          f"{n} reads would take the host sweep, not the device one")
    t0 = time.perf_counter()
    dev = greedy_scs.find_overlaps(codes)
    t1 = time.perf_counter()
    host = greedy_scs._find_overlaps_host(codes)
    t2 = time.perf_counter()
    check(np.array_equal(dev.succ, host.succ)
          and np.array_equal(dev.overlap, host.overlap),
          f"device sweep differs from the host mirror in "
          f"{int((dev.succ != host.succ).sum())} links")
    return {"phase": "overlap_mirror", "reads": n,
            "links": int((dev.succ >= 0).sum()),
            "device_s": round(t1 - t0, 3), "host_s": round(t2 - t1, 3)}


def mesh_equality(work: str, n: int = MESH_READS, n_devices: int = 4) -> dict:
    """The archive built over an n_devices mesh equals the 1-device one made
    in the same process, and round-trips exactly."""
    from pgrc.archive import decoder, encoder
    from pgrc.config import PgRCParams
    from pgrc.parallel.mesh import make_mesh

    (src,) = synth(work, "mesh", n, seed=13)
    a1 = os.path.join(work, "mesh_1.pgtc")
    am = os.path.join(work, f"mesh_{n_devices}.pgtc")
    t0 = time.perf_counter()
    encoder.encode(PgRCParams(src_fastq=src, output=a1))
    t1 = time.perf_counter()
    encoder.encode(PgRCParams(src_fastq=src, output=am),
                   mesh=make_mesh(n_devices))
    t2 = time.perf_counter()
    b1, bm = _read(a1), _read(am)
    check(b1 == bm, f"{n_devices}-device archive differs from the 1-device "
                    f"one ({len(bm)} vs {len(b1)} B)")
    decoder.decode_to_files(am, am)
    check(same_reads([seq_lines(src)], [decoded_lines(am + "_out", READ_LEN)],
                     ordered=False), "mesh archive does not round-trip")
    _remove(src, a1, am, am + "_out")
    return {"phase": f"mesh{n_devices}_equality", "reads": n,
            "archive_bytes": len(b1), "one_device_s": round(t1 - t0, 3),
            "mesh_s": round(t2 - t1, 3)}


def single_card_phases():
    return [
        backend_equality,
        overlap_mirror,
        lambda w: roundtrip(w, "pe", PE_PAIRS, seed=21, pair=True),
        lambda w: roundtrip(w, "se_ord", SE_ORD_READS, seed=22, ordered=True),
        lambda w: roundtrip(w, "pe_ord", PE_ORD_PAIRS, seed=23, pair=True,
                            ordered=True),
        lambda w: roundtrip(w, "se", SE_READS, seed=9),
    ]


def _process_peak_device_bytes():
    """The largest device memory in use at any time so far in this process
    (JAX keeps one peak per process; it is never reset between phases)."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the 4-device mesh phase")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < args.chips:
        print(f"chip_smoke: needs {args.chips} GPU(s); JAX found "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        return 1
    info = device.describe()
    print(f"device: platform={info['platform']} kind={info['kind']} "
          f"count={info['count']}", flush=True)
    smi = device.gpu_name_and_power_limit()
    if smi is None:
        print("chip_smoke: nvidia-smi did not answer", file=sys.stderr)
        return 1
    print(smi, flush=True)
    if native.get_lib() is None:
        print("chip_smoke: the native runtime did not build or load",
              file=sys.stderr)
        return 1

    phases = ([mesh_equality] if args.chips == 4 else single_card_phases())
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        for phase in phases:
            try:
                res = phase(work)
            except SmokeFailure as e:
                print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
                return 1
            res["process_peak_device_bytes"] = _process_peak_device_bytes()
            print(json.dumps(res), flush=True)
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
