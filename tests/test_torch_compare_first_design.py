"""compare_first_design.py checks the C entry points of the checkout it
builds before it loads them: the first design's signatures pass, and any
other (this checkout's kernels, which take other arguments) is refused
before nvcc runs."""
import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "compare_first_design", ROOT / "compare_first_design.py")
cfd = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cfd)

FIRST = {
    "pipe_cell.cu": """
extern "C" int bito_pipe_cell(const int* idx, const void* big, float* scratch,
                              float* out, int cells, int block_rows,
                              int scratch_rows, int S, int init, int loops,
                              int stores, void* stream) {
  return 0;
}""",
    "static_chain.cu": """
extern "C" int bito_static_chain(const int* tape, const float* L, float* out,
                                 int S, int R, int dynamic, void* stream) {
  return 0;
}""",
}


@pytest.mark.parametrize("file", sorted(FIRST))
def test_first_design_signatures_parse(file):
    name, want = cfd.SIGNATURES[file]
    assert cfd.parameter_types(FIRST[file], name) == want


@pytest.mark.parametrize("file", sorted(FIRST))
def test_this_checkouts_kernels_are_refused(tmp_path, monkeypatch, file):
    """Pointed at this checkout, or at a checkout whose entry point lost or
    gained an argument, build_first raises before any build."""
    def no_build(*args, **kwargs):
        raise AssertionError("nvcc ran")
    monkeypatch.setattr(cfd.subprocess, "run", no_build)
    with pytest.raises(ValueError, match="first design"):
        cfd.build_first(ROOT)
    csrc = tmp_path / "bito_tpu_torch/perflab/csrc"
    csrc.mkdir(parents=True)
    for name, text in FIRST.items():
        (csrc / name).write_text(text)
    (csrc / file).write_text(FIRST[file].replace("void* stream",
                                                 "int extra, void* stream"))
    with pytest.raises(ValueError, match="first design"):
        cfd.build_first(tmp_path)
    with pytest.raises(ValueError, match="no extern"):
        cfd.parameter_types("int main() {}", "bito_pipe_cell")
