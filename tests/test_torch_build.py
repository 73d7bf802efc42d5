"""The kernels' build (:mod:`dhts_torch.ops.cuda._build`) names each library
by the content of its source and of every ``csrc/`` header the source
includes, so an edited header builds a new library instead of loading a
stale one."""

import shutil

import pytest

from dhts_torch.ops.cuda import _build

SOURCES = ["itscp_hybrid_episode", "macro_rollout", "micro_rollout"]


@pytest.mark.parametrize("name", SOURCES)
def test_every_source_includes_the_shared_header(name):
    files = [f.name for f in _build._included(
        _build.CSRC / f"{name}.cu", _build.CSRC, set())]
    assert files[0] == f"{name}.cu" and "dhts_scalar.cuh" in files


@pytest.mark.parametrize("header", ["dhts_scalar.cuh", "cpu_emulation.h"])
@pytest.mark.parametrize("name", SOURCES)
def test_editing_a_header_names_a_new_library(tmp_path, name, header):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = _build.library_path(name, csrc)
    assert before == _build.library_path(name)  # the copy names the same
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    after = _build.library_path(name, csrc)
    assert after != before and after.parent == before.parent


def test_editing_another_source_keeps_the_name(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = _build.library_path("macro_rollout", csrc)
    with open(csrc / "micro_rollout.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path("macro_rollout", csrc) == before


def test_missing_source_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        _build.library_path("no_such_kernel", tmp_path)


def test_a_build_with_macros_names_its_own_library():
    """An instrumented build (``-DDHTS_STEP_CLOCK``, the step's cycle
    stamps) never loads as the plain one, nor the plain one as it."""
    plain = _build.library_path("macro_rollout")
    clocked = _build.library_path("macro_rollout",
                                  defines=("DHTS_STEP_CLOCK",))
    assert clocked != plain and clocked.parent == plain.parent
    assert clocked == _build.library_path("macro_rollout",
                                          defines=["DHTS_STEP_CLOCK"])
