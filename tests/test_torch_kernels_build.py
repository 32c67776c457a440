"""The kernel build (treelike/_kernels.py) without a CUDA toolkit: a
stand-in nvcc script shows that a build runs once per source hash, keeps
nvcc's messages beside the library, and raises with nvcc's stderr when
the compile fails."""
import os
import stat

import pytest

from bito_tpu_torch.treelike import _kernels


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture
def sandbox(tmp_path, monkeypatch):
    """Copies of the sources and an empty build directory under tmp_path."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in _kernels._SOURCES + _kernels._HEADERS:
        (csrc / name).write_bytes((_kernels._CSRC / name).read_bytes())
    monkeypatch.setattr(_kernels, "_CSRC", csrc)
    monkeypatch.setattr(_kernels, "_BUILD", tmp_path / "_build")
    return tmp_path


def test_build_once_per_source_hash(sandbox, monkeypatch):
    calls = sandbox / "calls"
    # Record the call, print a ptxas-like line, write the -o target.
    nvcc = _fake_nvcc(sandbox, f"""
echo run >> {calls}
echo 'ptxas info    : Used 56 registers' >&2
while [ "$1" != "-o" ]; do shift; done
touch "$2"
""")
    monkeypatch.setattr(_kernels, "_nvcc", lambda: nvcc)
    so = _kernels.build()
    assert so.exists() and so.parent == sandbox / "_build"
    assert "Used 56 registers" in so.with_suffix(".log").read_text()
    assert _kernels.build() == so
    assert calls.read_text().count("run") == 1  # the second call reused it
    assert not [p for p in so.parent.iterdir() if ".tmp." in p.name]

    # An edit to a source names a new library and builds again.
    src = sandbox / "csrc" / _kernels._SOURCES[0]
    src.write_text(src.read_text() + "\n// edited\n")
    so2 = _kernels.build()
    assert so2 != so and so2.exists()
    assert calls.read_text().count("run") == 2


def test_failed_build_raises_with_nvcc_stderr(sandbox, monkeypatch):
    nvcc = _fake_nvcc(sandbox, "echo 'error: identifier \"x\" is undefined' >&2\n"
                               "exit 2\n")
    monkeypatch.setattr(_kernels, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match='identifier "x" is undefined'):
        _kernels.build()
    assert not _kernels.library_path().exists()
    assert not [p for p in (sandbox / "_build").iterdir()]


def test_missing_nvcc_raises(sandbox, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(sandbox / "no_cuda"))
    monkeypatch.setenv("PATH", str(sandbox / "no_bin"))
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    with pytest.raises(FileNotFoundError, match="nvcc"):
        _kernels.build()
    assert not (sandbox / "_build").exists()
