"""The kernel build of ``consul_tpu_torch.ops._build``, with a stand-in nvcc.

No CUDA compiler exists on the machines that run these tests, so a small
shell script plays nvcc: it records its arguments and either writes the
``-o`` file or fails.  The real build runs in ``chip_smoke.py``.
"""

import os
import stat

import pytest

from consul_tpu_torch.ops import _build


def _fake_nvcc(home, ok=True):
    bin_dir = home / "bin"
    bin_dir.mkdir(parents=True)
    script = bin_dir / "nvcc"
    body = (
        '#!/bin/sh\necho "$@" >> "$(dirname "$0")/calls"\n'
        + ('while [ "$1" != "-o" ]; do shift; done\necho lib > "$2"\n'
           if ok else 'echo "error: bad kernel" >&2\nexit 2\n')
    )
    script.write_text(body)
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return bin_dir / "calls"


@pytest.fixture
def sandbox(tmp_path, monkeypatch):
    """A csrc with one kernel source and an empty build directory."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    return tmp_path


def test_nvcc_from_cuda_home(sandbox):
    _fake_nvcc(sandbox / "cuda")
    assert _build.nvcc() == str(sandbox / "cuda" / "bin" / "nvcc")


def test_nvcc_missing_raises(sandbox, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_build_once_for_sm90a_and_again_after_an_edit(sandbox):
    calls = _fake_nvcc(sandbox / "cuda")
    _build.build("k")
    _build.build("k")
    lines = calls.read_text().splitlines()
    assert len(lines) == 1, "an unchanged source builds once"
    assert "arch=compute_90a,code=sm_90a" in lines[0]
    built = sorted(p.name for p in (sandbox / "_build").iterdir())
    assert len(built) == 1 and built[0].startswith("libk-")
    (sandbox / "csrc" / "k.cu").write_text("// kernel, edited\n")
    _build.build("k")
    assert len(calls.read_text().splitlines()) == 2
    assert len(os.listdir(sandbox / "_build")) == 2


def test_failed_build_raises_with_compiler_output(sandbox):
    _fake_nvcc(sandbox / "cuda", ok=False)
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build("k")
    assert not any((sandbox / "_build").glob("libk-*.so"))
