"""The port's kernel build (``repro_torch.kernels._build``) on the CPU: a
library's name follows its source, every shared header and the flags, so
no stale library is loaded after an edit."""

from repro_torch.kernels import _build


def _fake_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "shared.cuh"\n')
    (csrc / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    return csrc


def test_library_name_follows_every_shared_header(tmp_path, monkeypatch):
    csrc = _fake_csrc(tmp_path, monkeypatch)
    first = _build._lib_path("k")
    assert first == _build._lib_path("k")            # stable
    (csrc / "shared.cuh").write_text("// v2\n")
    edited = _build._lib_path("k")
    assert edited != first
    (csrc / "other.cuh").write_text("// new header\n")
    assert _build._lib_path("k") not in (first, edited)
    assert _build._lib_path("k").parent == _build.BUILD_DIR
    assert _build._lib_path("k").name.startswith("k-")


def test_library_name_follows_the_source_and_flags(tmp_path, monkeypatch):
    csrc = _fake_csrc(tmp_path, monkeypatch)
    first = _build._lib_path("k")
    (csrc / "k.cu").write_text('#include "shared.cuh"\n// edit\n')
    second = _build._lib_path("k")
    assert second != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    assert _build._lib_path("k") != second


def test_the_threshold_kernels_share_the_epilogue_header():
    for name in ("threshold_matmul", "conv_threshold"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "threshold_epilogue.cuh"' in src
    assert (_build.CSRC / "threshold_epilogue.cuh").is_file()
