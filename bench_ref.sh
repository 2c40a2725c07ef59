#!/bin/bash
# Build the reference PgRC binary out-of-tree and measure its 8-thread
# compression throughput on the same synthetic input bench.py uses.
# Records build-ref/baseline.json for bench.py's vs_baseline.
set -e
cd "$(dirname "$0")"
mkdir -p build-ref
if [ ! -x build-ref/PgRC ]; then
  (cd build-ref && cmake /root/reference -DCMAKE_BUILD_TYPE=Release >/dev/null && make -j2 PgRC)
fi
N=${PGRC_BENCH_READS:-200000}
TMP=${PGRC_BENCH_TMP:-$PWD/bench_data}
mkdir -p "$TMP"
SRC="$TMP/bench_${N}.fastq"
if [ ! -f "$SRC" ]; then
  PGRC_BENCH_READS=$N PGRC_BENCH_TMP=$TMP python - <<'EOF'
import os, sys
sys.path.insert(0, os.path.dirname(os.path.abspath("bench.py")))
import bench
n = int(os.environ.get("PGRC_BENCH_READS", 200000))
tmp = os.environ["PGRC_BENCH_TMP"]
bench.synth_fastq(os.path.join(tmp, f"bench_{n}.fastq"), n, 100, max(n*100//40, 200000), seed=7)
EOF
fi
# median of 3 runs: a single sample is hostage to transient load (the r3
# baseline recorded 3.55 s where an idle machine measures ~1.4 s)
TIMES=""
for i in 1 2 3; do
  START=$(python -c 'import time; print(time.time())')
  ./build-ref/PgRC -t 8 -i "$SRC" "$TMP/ref.pgrc"
  END=$(python -c 'import time; print(time.time())')
  TIMES="$TIMES $(python -c "print($END-$START)")"
done
SIZE=$(stat -c %s "$TMP/ref.pgrc")
N=$N TIMES="$TIMES" SIZE=$SIZE python - <<'EOF'
import json, os, statistics
n = int(os.environ["N"]); dt = statistics.median(
    float(x) for x in os.environ["TIMES"].split())
size = int(os.environ["SIZE"]); bases = n * 100
rec = {"mbases_per_s": round(bases / 1e6 / dt, 3), "seconds": round(dt, 3),
       "archive_bytes": size, "reads": n,
       "bits_per_base": round(size * 8 / bases, 4)}
with open("build-ref/baseline.json", "w") as f:
    json.dump(rec, f)
print(json.dumps(rec))
EOF
