"""The kernel build (treelike/_kernels.py) without a CUDA toolkit: a
stand-in nvcc script shows that a build compiles every source of the
tree-likelihood kernels, the model prep's kernel and the perf-lab probes,
one nvcc each, and links them into one library named by the sources'
hash; that it runs once per source hash, keeps nvcc's messages beside the
library, and raises with nvcc's stderr when a compile fails."""
import os
import pathlib
import re
import stat

import pytest

from bito_tpu_torch.treelike import _kernels


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """Copies of the sources, in their package layout, and an empty build
    directory under tmp_path."""
    root = tmp_path / "pkg"
    for name in _kernels._SOURCES + _kernels._HEADERS:
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        (root / name).write_bytes((_kernels._ROOT / name).read_bytes())
    monkeypatch.setattr(_kernels, "_ROOT", root)
    monkeypatch.setattr(_kernels, "_BUILD", tmp_path / "_build")
    return tmp_path


def test_build_once_per_source_hash(workdir, monkeypatch):
    calls = workdir / "calls"
    # Record the call, print a ptxas-like line, write the -o target.
    nvcc = _fake_nvcc(workdir, f"""
echo "$@" >> {calls}
echo 'ptxas info    : Used 56 registers' >&2
while [ "$1" != "-o" ]; do shift; done
touch "$2"
""")
    monkeypatch.setattr(_kernels, "_nvcc", lambda: nvcc)
    so = _kernels.build()
    assert so.exists() and so.parent == workdir / "_build"
    assert re.fullmatch(r"libbito_kernels_[0-9a-f]{16}\.so", so.name)
    assert "Used 56 registers" in so.with_suffix(".log").read_text()
    runs = calls.read_text().splitlines()
    # One compile per source, then one link of all their objects.
    assert sorted(r.split()[-1] for r in runs[:-1]) == sorted(
        str(workdir / "pkg" / s) for s in _kernels._SOURCES)
    assert {pathlib.PurePath(s).parts[0] for s in _kernels._SOURCES} == {
        "treelike", "models", "perflab"}
    assert all(" -c " in r and "sm_90a" in r for r in runs[:-1])
    assert " -shared " in runs[-1] and runs[-1].count(".o") == len(
        _kernels._SOURCES)
    assert _kernels.build() == so
    assert len(calls.read_text().splitlines()) == len(runs)  # reused
    assert sorted(p.name for p in so.parent.iterdir()) == sorted(
        [so.name, so.with_suffix(".log").name])

    # An edit to any source names a new library and builds again.
    for name in ("treelike/csrc/chunked_grad.cu", "treelike/csrc/common.cuh",
                 "perflab/csrc/static_chain.cu",
                 "treelike/csrc/pernode_onchip.cuh",
                 "models/csrc/transition_prep.cu"):
        src = workdir / "pkg" / name
        src.write_text(src.read_text() + "\n// edited\n")
        so2 = _kernels.build()
        assert so2 != so and so2.exists()
        so = so2
    assert len(calls.read_text().splitlines()) == 6 * len(runs)


def test_every_included_header_is_hashed():
    """Each header a source includes is one of _HEADERS, so that an edit to
    it names a new library (the per-node on-chip body is a header that two
    sources instantiate)."""
    for name in _kernels._SOURCES + _kernels._HEADERS:
        path = _kernels._ROOT / name
        for inc in re.findall(r'#include "([^"]+)"', path.read_text()):
            rel = (path.parent / inc).resolve().relative_to(_kernels._ROOT)
            assert str(rel) in _kernels._HEADERS, (name, inc)
    assert "treelike/csrc/pernode_grad_onchip.cu" in _kernels._SOURCES


def test_failed_build_raises_with_nvcc_stderr(workdir, monkeypatch):
    nvcc = _fake_nvcc(workdir, "echo 'error: identifier \"x\" is undefined' >&2\n"
                               "exit 2\n")
    monkeypatch.setattr(_kernels, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match='identifier "x" is undefined'):
        _kernels.build()
    assert not _kernels.library_path().exists()
    assert not [p for p in (workdir / "_build").iterdir()]


def test_missing_nvcc_raises(workdir, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(workdir / "no_cuda"))
    monkeypatch.setenv("PATH", str(workdir / "no_bin"))
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    with pytest.raises(FileNotFoundError, match="nvcc"):
        _kernels.build()
    assert not (workdir / "_build").exists()
