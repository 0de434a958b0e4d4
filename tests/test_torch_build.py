"""The kernel builder's cache: one compile per source and flags, and the
ptxas report kept beside the library, so a library built earlier still
reports its registers and spills (``chip_smoke.py`` checks them).

nvcc is replaced by a stand-in script that writes the output file and a
ptxas-like line; no CUDA toolkit is needed.
"""
import os
import stat
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build as build_mod  # noqa: E402

_FAKE_NVCC = """#!{python}
import pathlib, sys
args = sys.argv[1:]
pathlib.Path(args[args.index("-o") + 1]).write_bytes(b"lib")
with open(pathlib.Path(sys.argv[0]).with_suffix(".calls"), "a") as f:
    f.write("x")
print("    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
"""


def test_build_keeps_the_ptxas_log_beside_the_library(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    source = tmp_path / "k.cu"
    source.write_text("// a kernel\n")
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build_mod, "_nvcc", lambda: str(nvcc))

    first = build_mod.build(source)
    again = build_mod.build(source)

    assert (tmp_path / "nvcc.calls").read_text() == "x"  # compiled once
    assert first["library"] == again["library"]
    assert open(first["library"], "rb").read() == b"lib"
    assert "0 bytes spill stores" in first["log"]
    assert again["log"] == first["log"] and again["seconds"] == 0.0
    assert sorted(os.listdir(tmp_path / "out")) == sorted(
        [os.path.basename(first["library"]),
         os.path.basename(first["library"])[:-3] + ".log"])
