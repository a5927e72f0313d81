"""The port's kernel build (tpunet_torch/ops/_build.py), checked without
nvcc: a library's file name changes with its source and with every shared
header under csrc/, so an edited header is never served by a stale build,
and a header is never built on its own."""

import shutil

from tpunet_torch.ops import _build
import _torch_threads  # noqa: E402,F401


def _copy_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    return csrc


def test_library_path_follows_shared_headers(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["mma_sm90.cuh"]
    before = {n: _build.library_path(n) for n in _build.sources()}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.sources()}
    for name in before:
        assert before[name] != after[name], name
        assert after[name].parent == _build.BUILD_DIR


def test_library_path_ignores_other_files(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = _build.library_path("fused_ir")
    (csrc / "notes.txt").write_text("not a source")
    assert _build.library_path("fused_ir") == before
    (csrc / "fused_ir.cu").write_text((csrc / "fused_ir.cu").read_text()
                                      + "\n")
    assert _build.library_path("fused_ir") != before


def test_sources_are_the_cu_files_only(tmp_path, monkeypatch):
    _copy_csrc(tmp_path, monkeypatch)
    assert _build.sources() == ["depthwise", "flash", "fused_ir"]
