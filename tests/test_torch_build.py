"""The CUDA kernels' build table (``repro_torch.kernels._build``), checked on
the CPU: no ``nvcc`` is run.

Each ``csrc/*.cu`` takes its flags from one table.  The sources held
bit-equal to their plain versions keep ``-fmad=false``; every source
targets ``sm_90a``; the library's name hashes the flags, so that a change
of flags rebuilds.
"""
import pytest

from repro_torch.kernels import _build

SOURCES = sorted(p.stem for p in _build.CSRC.glob("*.cu"))


def test_every_source_has_a_row_in_the_table():
    assert SOURCES == sorted(_build.SOURCE_FLAGS)
    with pytest.raises(KeyError):
        _build.flags_for("no_such_kernel")


@pytest.mark.parametrize("name", SOURCES)
def test_every_source_targets_sm_90a(name):
    flags = _build.flags_for(name)
    assert "-gencode=arch=compute_90a,code=sm_90a" in flags
    assert not any("use_fast_math" in f for f in flags)


@pytest.mark.parametrize("name,fmad_off", [
    ("wan_codec", True), ("topk_compress", True),
    ("flash_attention", False), ("ssd_scan", False)])
def test_bit_exact_sources_keep_fmad_false(name, fmad_off):
    assert ("-fmad=false" in _build.flags_for(name)) == fmad_off


@pytest.mark.parametrize("name", SOURCES)
def test_target_hash_follows_the_flags(name, monkeypatch):
    before = _build._target(name, _build.flags_for(name))
    assert before.parent == _build.BUILD_DIR
    assert before.name.startswith(f"lib{name}_")
    assert _build._target(name, _build.flags_for(name)) == before
    monkeypatch.setitem(_build.SOURCE_FLAGS, name,
                        _build.SOURCE_FLAGS[name] + ("-lineinfo",))
    assert _build._target(name, _build.flags_for(name)) != before
