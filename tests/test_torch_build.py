"""The port's kernel build keys each library by its source, every header
under ``csrc/`` and the compiler flags, so an edited header builds anew;
the wrappers resolve each C entry point once. These tests only hash files
and use a stand-in library: they need no ``nvcc`` and no card."""

import ctypes
import os
import re
import shutil

import pytest

from photon_ml_tpu_torch.kernels import build, ell, fused, lab


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``kernels/csrc`` that the build reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, copy)
    monkeypatch.setattr(build, "CSRC_DIR", str(copy))
    return copy


def _paths():
    return {name: build.library_path(name) for name in build.SOURCES}


def _append(path, text):
    with open(path, "a") as f:
        f.write(text)


def test_every_source_and_header_is_in_the_tree():
    names = set(os.listdir(build.CSRC_DIR))
    assert set(build.SOURCES) == {"ell_matvec", "ell_scatter_add", "fused", "colsort", "lab"}
    assert set(build.SOURCES.values()) <= names
    assert {"ell_common.cuh", "ell_tile.cuh", "colsort.cuh"} <= names


def test_unchanged_tree_gives_the_same_paths(csrc):
    first = _paths()
    assert _paths() == first
    assert len(set(first.values())) == len(build.SOURCES)
    for name, path in first.items():
        assert os.path.dirname(path) == build.BUILD_DIR
        assert os.path.basename(path).startswith(f"lib{name}-") and path.endswith(".so")


@pytest.mark.parametrize("name", sorted(build.SOURCES))
def test_header_edit_changes_the_library_path(csrc, name):
    before = build.library_path(name)
    _append(csrc / "ell_common.cuh", "\n// edited\n")
    assert build.library_path(name) != before


@pytest.mark.parametrize("name", sorted(build.SOURCES))
def test_new_header_changes_the_library_path(csrc, name):
    before = build.library_path(name)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path(name) != before


def test_source_edit_changes_only_its_library(csrc):
    before = _paths()
    _append(csrc / build.SOURCES["ell_matvec"], "\n// edited\n")
    after = _paths()
    assert after["ell_matvec"] != before["ell_matvec"]
    assert {n: p for n, p in after.items() if n != "ell_matvec"} == {
        n: p for n, p in before.items() if n != "ell_matvec"}


def test_flags_are_in_the_hash(csrc, monkeypatch):
    before = _paths()
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    after = _paths()
    assert all(after[n] != before[n] for n in build.SOURCES)


def test_load_entry_resolves_each_entry_once(monkeypatch):
    class Lib:
        """Stands in for a ctypes.CDLL: each attribute a new function."""

        def __init__(self):
            self.looked_up = []

        def __getattr__(self, name):
            self.looked_up.append(name)
            return type("Fn", (), {"argtypes": None, "restype": None})()

    lib, loads = Lib(), []
    monkeypatch.setattr(build, "load", lambda name: loads.append(name) or lib)
    monkeypatch.setattr(ell, "_entries", {})
    first = ell.load_entry("fused", "photon_a", [ctypes.c_int], ctypes.c_longlong)
    assert ell.load_entry("fused", "photon_a", [ctypes.c_void_p]) == first
    assert first[0] is lib and loads == ["fused"] and lib.looked_up == ["photon_a"]
    assert first[1].argtypes == [ctypes.c_int] and first[1].restype is ctypes.c_longlong
    other = ell.load_entry("fused", "photon_b", [])
    assert other[1].restype is ctypes.c_int and lib.looked_up == ["photon_a", "photon_b"]


def test_fused_library_exports_the_tile_entries_only():
    """Every fused pass runs on tiles of whole rows: the library exports
    each entry its wrappers load and ``photon_fused_tile_blocks`` that
    sizes their partials, and no longer the lane-per-row
    ``photon_fused_blocks``; no source keeps the ``row_dot`` loop."""
    with open(os.path.join(build.CSRC_DIR, build.SOURCES["fused"])) as f:
        source = f.read()
    exported = source[source.index('extern "C" {'):]
    names = set(re.findall(r"\b(photon_\w+)\(", exported))
    for suffix in re.findall(r"^PHOTON_FUSED_ENTRIES\((\w+),", exported, re.M):
        names |= {n.replace("##SUFFIX", suffix)
                  for n in re.findall(r"\b(photon_\w+##SUFFIX)\(", exported)}
    wanted = {f"photon_fused_{p}_{s}" for p in ("vgc", "hvp", "hdiag")
              for s in fused._FUSED_TYPES.values()}
    assert wanted | {"photon_fused_tile_blocks"} <= names
    assert "photon_fused_blocks" not in names and "photon_fused_blocks" not in source
    for name in os.listdir(build.CSRC_DIR):
        with open(os.path.join(build.CSRC_DIR, name)) as f:
            assert "row_dot" not in f.read(), name


def _exported(library):
    with open(os.path.join(build.CSRC_DIR, build.SOURCES[library])) as f:
        source = f.read()
    return source, set(re.findall(r"\b(photon_\w+)\(", source[source.index('extern "C" {'):]))


def test_lab_library_exports_every_entry_its_wrappers_load():
    """``lab.cu`` exports the three entries ``kernels/lab.py`` loads, and the
    error string every library has."""
    _, names = _exported("lab")
    with open(lab.__file__) as f:
        loaded = set(re.findall(r'"(photon_lab_\w+)"', f.read()))
    assert loaded == {"photon_lab_lane_gather", "photon_lab_onehot_gather",
                      "photon_lab_onehot_reduce"}
    assert loaded | {"photon_cuda_error_string"} <= names


def test_onehot_reduce_source_has_no_atomics():
    """The column-sorted reduce writes each column once, in a fixed order:
    no atomic anywhere in ``lab.cu``."""
    source, _ = _exported("lab")
    code = re.sub(r"//[^\n]*", "", source)
    assert "onehot_reduce_tiles_kernel" in code and "onehot_reduce_chains_kernel" in code
    assert "atomic" not in code.lower()
