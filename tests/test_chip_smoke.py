"""chip_smoke.py on the CPU: main() refuses to run without a GPU, and every
phase function runs end to end at ~3000 reads, exercising the exact
comparisons that decide the smoke's result on the card."""
import json

import numpy as np
import pytest

import chip_smoke as cs


def test_main_refuses_the_cpu_before_any_work(monkeypatch, capsys):
    ran = []
    monkeypatch.setattr(cs, "single_card_phases",
                        lambda: [lambda w: ran.append(w)])
    monkeypatch.setattr(cs, "mesh_equality", lambda w: ran.append(w))
    for argv in ([], ["--chips", "4"]):
        assert cs.main(argv) != 0
    assert not ran
    out = capsys.readouterr().out
    assert '"ok"' not in out
    for line in out.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


@pytest.mark.parametrize("phase", [
    lambda w: cs.backend_equality(w, 3000),
    lambda w: cs.overlap_mirror(w, 4000),
    lambda w: cs.roundtrip(w, "se", 3000, seed=9),
    lambda w: cs.roundtrip(w, "pe", 1500, seed=21, pair=True),
    lambda w: cs.roundtrip(w, "se_ord", 3000, seed=22, ordered=True),
    lambda w: cs.roundtrip(w, "pe_ord", 1500, seed=23, pair=True,
                           ordered=True),
], ids=["backend_equality", "overlap_mirror", "se", "pe", "se_ord", "pe_ord"])
def test_phase_runs_on_cpu(tmp_path, phase):
    res = phase(str(tmp_path))
    assert res["reads"] >= 3000
    if "bits_per_base" in res:
        assert 0 < res["bits_per_base"] < 2.5
    assert not list(tmp_path.iterdir())   # the phase cleans up after itself


def test_mesh_phase_on_four_virtual_devices(tmp_path):
    import jax

    assert len(jax.devices()) >= 4, "conftest provisions 8 virtual devices"
    res = cs.mesh_equality(str(tmp_path), 3000, n_devices=4)
    assert res["phase"] == "mesh4_equality" and res["archive_bytes"] > 0


def test_same_reads_is_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(65, 69, size=(50, 10), dtype=np.uint8)
    b = rng.integers(65, 69, size=(50, 10), dtype=np.uint8)
    perm = rng.permutation(50)
    assert cs.same_reads([a, b], [a[perm], b[perm]], ordered=False)
    assert not cs.same_reads([a, b], [a[perm], b[perm]], ordered=True)
    assert cs.same_reads([a, b], [a, b], ordered=True)
    # the faults a summed per-line hash lets through
    swapped = a.copy()
    swapped[:, [2, 3]] = swapped[:, [3, 2]]
    if not np.array_equal(swapped, a):
        assert not cs.same_reads([a], [swapped], ordered=False)
    assert not cs.same_reads([a, b], [a, b[::-1]], ordered=False)  # re-paired
    assert not cs.same_reads([a], [a[:-1]], ordered=False)


def test_line_parsers_round_trip(tmp_path):
    fq = tmp_path / "x.fastq"
    fq.write_bytes(b"@a\nACGT\n+\nIIII\n@bb\nTTAC\n+\nIIII\n")
    assert cs.seq_lines(str(fq)).tobytes() == b"ACGTTTAC"
    dec = tmp_path / "x_out"
    dec.write_bytes(b"ACGT\nTTAC\n")
    assert np.array_equal(cs.decoded_lines(str(dec), 4), cs.seq_lines(str(fq)))
    dec.write_bytes(b"ACGT\nTTA\n")
    with pytest.raises(cs.SmokeFailure):
        cs.decoded_lines(str(dec), 4)
