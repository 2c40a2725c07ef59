"""Backend choice, compile-cache location, native build key and the retired
zstd codec id: the parts of the program that decide where it runs and what
it writes, independent of the device it finds."""
import io

import pytest

from pgrc import device, native
from pgrc.streams import codecs, container
from pgrc.utils.errors import PgtcFormatError


def test_platform_cpu_when_requested(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert device.platform() == "cpu"
    jax, jnp = device.jax_modules()
    assert jax.default_backend() == "cpu"
    assert jnp.asarray(2**40).dtype == jnp.int64   # x64 on: int64 positions


@pytest.mark.parametrize("probed", ["cpu", "interpreter"])
def test_platform_refuses_a_non_gpu_default(monkeypatch, probed):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(device, "_probe", lambda: probed)
    with pytest.raises(RuntimeError, match="JAX_PLATFORMS=cpu"):
        device.platform()


def test_platform_accepts_a_gpu_default(monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(device, "_probe", lambda: "gpu")
    assert device.platform() == "gpu"


def test_cache_dir_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.cache_dir() is None   # JAX reads the variable itself


def test_cache_dir_fallback_is_fixed_in_checkout(monkeypatch):
    import os

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert device.cache_dir() == os.path.join(repo, ".jax_cache")
    assert device.cache_dir() == device.cache_dir()
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_native_build_key_tracks_sources_flags_and_target():
    srcs = [b"int f() { return 1; }", b"int g();"]
    flags = ("-O3", "-march=native")
    key = native.build_key(srcs, flags, b"-march=skylake")
    assert key == native.build_key(list(srcs), flags, b"-march=skylake")
    assert key != native.build_key([b"int f() { return 2; }", srcs[1]],
                                   flags, b"-march=skylake")
    assert key != native.build_key(srcs, ("-O2", "-march=native"),
                                   b"-march=skylake")
    assert key != native.build_key(srcs, flags, b"-march=znver4")
    # part boundaries count: moving bytes between sources changes the key
    assert key != native.build_key([srcs[0] + srcs[1], b""], flags,
                                   b"-march=skylake")


def test_native_library_lives_under_its_key():
    import os

    lib = native.get_lib()
    if lib is None:
        pytest.skip("no C++ compiler")
    name = os.path.basename(lib._name)
    assert name.startswith("libpgrc_native-") and name.endswith(".so")
    assert os.path.dirname(lib._name) == native._BUILD_DIR


def test_retired_zstd_codec_id_raises():
    with pytest.raises(PgtcFormatError, match="codec id 3"):
        codecs.Codec(codecs.RETIRED_ZSTD).decompress(b"\x28\xb5\x2f\xfd", 4)
    # through the container: a stream record whose coder byte is 3
    rec = bytes([codecs.RETIRED_ZSTD, 19, 0, 4, 4]) + b"abcd"
    with pytest.raises(PgtcFormatError, match="codec id 3"):
        container.StreamReader(rec).read_one()


def test_encoder_never_writes_codec_id_3():
    from pgrc.streams import props

    for primary, alts in props.PROPS.values():
        for c in (primary, *alts):
            assert c.coder_id != codecs.RETIRED_ZSTD
    data = bytes([0, 1, 1, 0, 0, 0, 1, 0]) * 2048   # in every kind's alphabet
    out = io.BytesIO()
    container.write_streams(out, [props.job(k, k, data) for k in props.PROPS])
    reader = container.StreamReader(out.getvalue())
    for _ in props.PROPS:
        assert reader.buf[reader.pos] != codecs.RETIRED_ZSTD
        assert reader.read_one() == data


@pytest.mark.parametrize("old,new", [
    ("PGRC_OLD_TRACE", "PGRC_TRACE"),
    ("PGRC_OLD_TWO_PASS", "PGRC_TWO_PASS"),
    ("PGRC_OLD_RSS_TRACE", "PGRC_RSS_TRACE"),
    ("PGRC_OLD_JAX_CACHE", "JAX_COMPILATION_CACHE_DIR"),
])
def test_renamed_env_var_warns(old, new):
    import pgrc

    with pytest.warns(UserWarning, match=f"{old} is no longer read; set {new}"):
        said = pgrc.warn_renamed_env({old: "1", "PATH": "/bin"})
    assert len(said) == 1


def test_current_env_var_names_do_not_warn(recwarn):
    import pgrc

    env = {"PGRC_TRACE": "1", "PGRC_TWO_PASS": "1", "PGRC_RSS_TRACE": "1",
           "PGRC_BENCH_READS": "1000", "JAX_COMPILATION_CACHE_DIR": "/c"}
    assert pgrc.warn_renamed_env(env) == []
    assert not recwarn.list


def test_bench_dir_is_per_checkout(monkeypatch, tmp_path):
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(repo)
    sys.modules.pop("bench", None)
    import bench

    monkeypatch.setenv("PGRC_BENCH_TMP", str(tmp_path / "b"))
    assert bench.bench_dir() == str(tmp_path / "b")
    assert os.path.isdir(tmp_path / "b")
    monkeypatch.delenv("PGRC_BENCH_TMP")
    assert bench.bench_dir() == os.path.join(repo, "bench_data")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert "bench_data/" in f.read().split()
