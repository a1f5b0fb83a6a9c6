"""The port's copy of the client-header generator
(``ogl_beamforming_tpu_torch.params.codegen``): ``tests/test_codegen.py``
mirrored, and its output held byte for byte to the tracked
``generated/ogl_beamformer_lib.h`` and ``generated/matlab/*.m``.  Files are
written only to ``tmp_path``; nothing writes into ``generated/``."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from ogl_beamforming_tpu_torch.params.codegen import (generate_c_header,
                                                      generate_matlab_bindings,
                                                      write_generated)

REPO = Path(__file__).resolve().parent.parent
GENERATED = REPO / "generated"


def test_header_contents():
    h = generate_c_header()
    assert "BeamformerSimpleParameters" in h
    assert "beamformer_beamform_data" in h
    assert "BeamformerAcquisitionKind_UFORCES = 1" in h
    assert "BeamformerDecodeMode_None = 0" in h       # reference spelling
    assert "BeamformerSamplingMode_2X = 0" in h


def test_matlab_bindings():
    files = generate_matlab_bindings()
    assert "OGLBeamformerShaderKind.m" in files
    assert "OGLBeamformerSimpleParameters.m" in files
    assert "OGLBeamformer.m" in files
    assert "classdef OGLBeamformerShaderKind < int32" in \
        files["OGLBeamformerShaderKind.m"]
    assert "serialize" in files["OGLBeamformerSimpleParameters.m"]


@pytest.mark.skipif(shutil.which("cc") is None, reason="no C compiler")
def test_header_compiles(tmp_path):
    write_generated(tmp_path)
    src = tmp_path / "t.c"
    src.write_text(
        '#include "ogl_beamformer_lib.h"\n'
        "int main(void){BeamformerSimpleParameters p={0};"
        "(void)p;return 0;}\n")
    subprocess.run(["cc", "-I", str(tmp_path), "-c", str(src), "-o",
                    str(tmp_path / "t.o")], check=True, capture_output=True,
                   timeout=60)


def test_struct_sizes_match_native():
    """Generated header structs must match the port's compiled library."""
    import ctypes as ct

    from ogl_beamforming_tpu_torch.params.constants import API_VERSION
    from ogl_beamforming_tpu_torch.runtime import abi
    lib = abi.load_library()   # performs its own ctypes<->C size checks
    assert lib.bf_abi_sizeof_parameters() == ct.sizeof(abi.CParameters)
    assert lib.beamformer_get_api_version() == API_VERSION


def test_written_files_equal_the_tracked_ones(tmp_path):
    written = write_generated(tmp_path)
    names = sorted(str(p.relative_to(tmp_path)) for p in written)
    tracked = sorted(str(p.relative_to(GENERATED))
                     for p in GENERATED.rglob("*") if p.is_file())
    assert names == tracked
    for name in names:
        assert (tmp_path / name).read_bytes() == \
            (GENERATED / name).read_bytes(), name


def test_main_needs_a_directory(tmp_path):
    """Without a directory the module writes nothing (the JAX package's
    copy defaults to ``generated/``)."""
    cmd = [sys.executable, "-m", "ogl_beamforming_tpu_torch.params.codegen"]
    run = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         timeout=60, env={"PYTHONPATH": str(REPO)})
    assert run.returncode != 0 and "usage" in run.stderr
    assert not any(tmp_path.iterdir())
