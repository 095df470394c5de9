"""The port's nvcc build cache (rapiddoc_tpu_torch/ops/build.py): where a
kernel's library goes must change with its source and with every header
it includes, so that a changed header rebuilds both kernels, and a
missing header is named before nvcc runs. Runs on a copy of csrc/ in a
temporary directory; nothing is compiled."""
import shutil
import tomllib
from pathlib import Path

import pytest

from rapiddoc_tpu_torch.ops import build

KERNELS = ("ctc_head", "quant_head")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, copy)
    monkeypatch.setattr(build, "CSRC_DIR", copy)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return copy


def test_sources_include_the_shared_header(csrc):
    assert sorted(p.name for p in csrc.glob("*.cuh")) == ["argmax_head.cuh"]
    for name in KERNELS:
        assert '#include "argmax_head.cuh"' in (csrc / f"{name}.cu").read_text()


@pytest.mark.parametrize("name", KERNELS)
def test_touching_the_header_moves_the_library(csrc, name):
    before = build.library_path(name)
    assert build.library_path(name) == before  # stable while nothing changes
    header = csrc / "argmax_head.cuh"
    header.write_text(header.read_text() + "\n// touched\n")
    after = build.library_path(name)
    assert after != before and after.name == before.name == f"lib{name}.so"


@pytest.mark.parametrize("name", KERNELS)
def test_a_source_moves_only_its_own_library(csrc, name):
    other = next(k for k in KERNELS if k != name)
    before = {k: build.library_path(k) for k in KERNELS}
    src = csrc / f"{name}.cu"
    src.write_text(src.read_text() + "\n// touched\n")
    assert build.library_path(name) != before[name]
    assert build.library_path(other) == before[other]


@pytest.mark.parametrize("name", KERNELS)
def test_a_missing_header_is_named(csrc, name):
    assert build.local_headers(name) == [csrc / "argmax_head.cuh"]
    (csrc / "argmax_head.cuh").unlink()
    with pytest.raises(FileNotFoundError, match="argmax_head.cuh"):
        build.library_path(name)


def test_package_data_ships_every_kernel_source():
    # an installed copy builds from its csrc/, headers included
    root = Path(__file__).resolve().parent.parent
    with open(root / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]["rapiddoc_tpu_torch"]
    pkg = build.CSRC_DIR.parent
    shipped = {p for pattern in data for p in pkg.glob(pattern)}
    assert sorted(build.CSRC_DIR.iterdir()) == sorted(p for p in shipped if p.parent == build.CSRC_DIR)
