"""The kernels' library names (ops/cuda `_lib_path`) follow every byte that
goes into a build: the `.cu` source and every header beside it in csrc/, so
that an edited header never loads a stale library. Needs no nvcc."""
from mvsformerplusplus_tpu_torch.ops import cuda


def test_library_name_follows_the_source_and_every_header(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    monkeypatch.setattr(cuda, "CSRC", csrc)
    monkeypatch.setattr(cuda, "BUILD_DIR", build)
    (csrc / "kern.cu").write_text('#include "frag.cuh"\nint f() { return g(); }\n')
    (csrc / "frag.cuh").write_text("inline int g() { return 1; }\n")
    first = cuda._lib_path("kern")
    assert first.parent == build and first.name.startswith("kern_") and first.suffix == ".so"
    assert cuda._lib_path("kern") == first
    (csrc / "frag.cuh").write_text("inline int g() { return 2; }\n")
    edited = cuda._lib_path("kern")
    assert edited != first
    (csrc / "other.cuh").write_text("// a new header\n")
    assert cuda._lib_path("kern") != edited
    (csrc / "kern.cu").write_text('#include "frag.cuh"\nint f() { return -g(); }\n')
    assert cuda._lib_path("kern") not in (first, edited)
