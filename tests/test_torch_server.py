"""The port's runtime bridge (``ogl_beamforming_tpu_torch.runtime``: abi,
server) on the CPU: the port's native library driven through ctypes exactly
as an external C/MATLAB client would, against a port ``BeamformerServer``
on ``Beamformer(device="cpu")``.

The first tests mirror ``tests/test_ipc.py`` case by case.  Then the port's
native sources against the JAX package's (byte for byte), its build (named
by the sources' hash, the Makefile's flags), the ``/dev/shm`` check, the
GPU default, and the JAX server and the port's side by side on the same
client calls: frames within 1e-4 NRMSE of the JAX frames (the DAS tolerance
of ``test_torch_pipeline.py``) and 1e-3 of golden, and the same error kinds
and stop-imaging behaviour.  Each server has its own shared-memory name and
each library its own globals (ctypes loads both with ``RTLD_LOCAL``).
Every client call that waits has a timeout (the library's global timeout),
every server thread is joined with one and its region unlinked.
"""

import ctypes as ct
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import nrmse  # noqa: E402

from ogl_beamforming_tpu.runtime import abi as jax_abi  # noqa: E402
from ogl_beamforming_tpu.runtime.server import (  # noqa: E402
    BeamformerServer as JaxServer)
from ogl_beamforming_tpu_torch.ops import golden  # noqa: E402
from ogl_beamforming_tpu_torch.params.enums import (  # noqa: E402
    AcquisitionKind, BeamformerError, DataKind, ErrorKind, InterpolationMode,
    LiveImagingDirtyFlags, ShaderKind)
from ogl_beamforming_tpu_torch.pipeline.executor import Beamformer  # noqa: E402
from ogl_beamforming_tpu_torch.runtime import abi, server as server_mod  # noqa: E402
from ogl_beamforming_tpu_torch.runtime.server import (  # noqa: E402
    BeamformerServer)
from ogl_beamforming_tpu_torch.utils.hadamard import hadamard  # noqa: E402
from ogl_beamforming_tpu_torch.utils.transforms import (  # noqa: E402
    das_transform_2d_xz)

REPO = Path(__file__).resolve().parent.parent
SHM_ENV = "OGL_BEAMFORMER_SHM_NAME"
TIMEOUT_MS = 15000     # the client library's global timeout
JOIN_S = 10.0          # a server thread's join


def _start(cls, name, **kw):
    os.environ[SHM_ENV] = name
    return cls(**kw).start()


def _stop(srv, name):
    """Stop a server (its region is unlinked under the name it was created
    with, which the library reads from the environment)."""
    os.environ[SHM_ENV] = name
    if isinstance(srv, BeamformerServer):
        srv.stop(timeout=JOIN_S)
    else:
        srv.stop()
    assert not srv._thread.is_alive()
    assert not Path("/dev/shm" + name).exists()


@pytest.fixture(scope="module")
def server():
    name = f"/bf_torch_test_{os.getpid()}"
    srv = _start(BeamformerServer, name, shm_size=64 << 20, device="cpu")
    srv.lib.beamformer_set_global_timeout(TIMEOUT_MS)
    yield srv
    _stop(srv, name)


@pytest.fixture(scope="module")
def jax_server(tmp_path_factory):
    """The JAX package's server, on its library built from its own sources
    into a scratch directory (its ``build_native`` would run ``make`` in
    the JAX package's tree, which other test files also build)."""
    lib = tmp_path_factory.mktemp("jax_native") / "libogl_beamformer_tpu.so"
    subprocess.run([abi.find_cc(), *abi.CFLAGS,
                    str(Path(jax_abi.NATIVE_DIR) / "beamformer_lib.c"),
                    *abi.LDFLAGS, "-o", str(lib)], check=True,
                   capture_output=True, timeout=120)
    name = f"/bf_torch_test_jax_{os.getpid()}"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_abi, "build_native", lambda force=False: lib)
        srv = _start(JaxServer, name, shm_size=64 << 20)
    srv.lib.beamformer_set_global_timeout(TIMEOUT_MS)
    yield srv
    _stop(srv, name)


def _fill_simple(mod=abi, c=8, a=4, s=256, nx=12, nz=16):
    """``tests/test_ipc.py``'s simple parameters, as ``mod``'s struct."""
    sp = mod.CSimpleParameters()
    p = sp.parameters
    pitch = 0.3e-3
    vt = das_transform_2d_xz([0, 1e-3], [(c - 1) * pitch, 8e-3])
    # row-major numpy -> column-major reference m4
    p.das_voxel_transform.E[:] = list(np.asarray(vt, np.float32).T.ravel())
    eye = np.eye(4, dtype=np.float32)
    p.xdc_transform.E[:] = list(eye.T.ravel())
    p.xdc_element_pitch.E[:] = [pitch, pitch]
    p.raw_data_dimensions.E[:] = [a * s, c]
    p.focal_vector.E[:] = [0.0, 0.0]
    p.sample_count = s
    p.channel_count = c
    p.acquisition_count = a
    p.acquisition_kind = int(AcquisitionKind.FORCES)
    p.decode_mode = 1
    p.time_offset = 0.0
    p.single_focus = 1
    p.single_orientation = 1
    p.output_points.E[:] = [nx, nz, 1, 0]
    p.sampling_frequency = 20e6
    p.demodulation_frequency = 5e6
    p.speed_of_sound = 1500.0
    p.f_number = 0.8
    p.interpolation_mode = int(InterpolationMode.Linear)
    p.decimation_rate = 1
    for i in range(256):
        sp.channel_mapping[i] = i
    sp.compute_stages[0] = int(ShaderKind.Decode)
    sp.compute_stages[1] = int(ShaderKind.DAS)
    sp.compute_stages_count = 2
    sp.data_kind = int(DataKind.Int16)
    return sp


def _golden(rf, c=8, a=4, s=256, nx=12, nz=16):
    """Golden decode + DAS of canonical (C, A, S) RF, x fastest."""
    dec = golden.decode_hadamard(rf, hadamard(a))
    dp = golden.DasParams(
        acquisition_kind=AcquisitionKind.FORCES, acquisition_count=a,
        channel_count=c, sample_count=s, sampling_frequency=20e6,
        demodulation_frequency=5e6, speed_of_sound=1500.0,
        interpolation_mode=InterpolationMode.Linear, f_number=0.8,
        voxel_transform=das_transform_2d_xz([0, 1e-3],
                                            [(c - 1) * 0.3e-3, 8e-3]),
        xdc_element_pitch=np.array([0.3e-3, 0.3e-3], np.float32),
        output_points=(nx, nz, 1))
    return np.asarray(golden.das(rf=dec, p=dp)).transpose(2, 1, 0).ravel()


def _wire(kind: DataKind, rng, c=8, a=4, s=256):
    """A raw frame of ``kind`` and its canonical (C, A, S) RF."""
    if kind == DataKind.Int16:
        raw = rng.integers(-1024, 1024, (c, a * s)).astype(np.int16)
        return raw, raw.reshape(c, a, s)
    if kind == DataKind.Int16Complex:
        raw = rng.integers(-1024, 1024, (c, a * s * 2)).astype(np.int16)
    else:
        raw = rng.standard_normal((c, a * s * 2)).astype(np.float32)
    pairs = raw.reshape(c, a, s * 2).astype(np.float32)
    return raw, (pairs[..., 0::2] + 1j * pairs[..., 1::2]).astype(
        np.complex64)


def _beamform(srv, mod, kind, raw, nx=12, nz=16):
    sp = _fill_simple(mod, nx=nx, nz=nz)
    sp.data_kind = int(kind)
    dtype = np.float32 if kind == DataKind.Int16 else np.complex64
    out = np.zeros(nx * nz, dtype)
    ok = srv.lib.beamformer_beamform_data(
        ct.byref(sp), raw.ctypes.data_as(ct.c_void_p), raw.nbytes,
        out.ctypes.data_as(ct.c_void_p), TIMEOUT_MS)
    assert ok == 1, srv.lib.beamformer_get_last_error_string()
    return out


def _push(lib, raw, plane=0, block=0):
    return lib.beamformer_push_data_with_compute(
        raw.ctypes.data_as(ct.c_void_p), raw.nbytes, plane, block)


def _flush(srv):
    """Wait until the server's sessions have taken every frame queued."""
    deadline = time.time() + JOIN_S
    for s in list(srv._sessions.values()):
        if isinstance(srv, BeamformerServer):
            s.flush(timeout=JOIN_S)
            continue
        # the JAX session's flush waits without a timeout
        while s._queue.unfinished_tasks and time.time() < deadline:
            time.sleep(0.01)
        assert not s._queue.unfinished_tasks


def _wait_frames(srv, n, timeout=JOIN_S):
    deadline = time.time() + timeout
    while srv.beamformer._frame_id < n and time.time() < deadline:
        time.sleep(0.01)
    return srv.beamformer._frame_id


# ---------------------------------------------------------------------------
# tests/test_ipc.py, case by case, on the port's server
# ---------------------------------------------------------------------------

def test_api_version(server):
    assert server.lib.beamformer_get_api_version() == 34


def test_error_strings(server):
    s = server.lib.beamformer_error_string(int(ErrorKind.WorkQueueFull))
    assert s == b"work queue full"


def test_beamform_data_end_to_end(server, rng):
    raw, rf = _wire(DataKind.Int16, rng)
    out = _beamform(server, abi, DataKind.Int16, raw)
    assert nrmse(_golden(rf), out) < 1e-3


def test_push_and_compute_advanced(server, rng):
    """Advanced API: push parameters/pipeline separately, then data."""
    lib = server.lib
    sp = _fill_simple()
    assert lib.beamformer_push_simple_parameters(ct.byref(sp)) == 1
    raw = rng.integers(-512, 512, (8, 4 * 256)).astype(np.int16)
    assert _push(lib, raw) == 1
    out = np.zeros(12 * 16, np.float32)
    assert lib.beamformer_get_last_frames(
        out.ctypes.data_as(ct.c_void_p), out.nbytes, 1) == 1
    assert np.abs(out).max() > 0


def test_compute_timings_export(server, rng):
    _beamform(server, abi, DataKind.Int16, _wire(DataKind.Int16, rng)[0])
    stats = abi.CStatsTable()
    assert server.lib.beamformer_compute_timings(ct.byref(stats), 1000) == 1
    assert int(ShaderKind.DAS) in list(stats.shader_ids)


def _error_sequence(lib, mod) -> list[int]:
    """tests/test_ipc.py::test_client_errors' calls; the error kind after
    each (each call must fail)."""
    kinds = []
    raw = np.zeros(16, np.int16)
    assert _push(lib, raw, plane=99) == 0             # bad image plane
    kinds.append(lib.beamformer_get_last_error())
    stages = (ct.c_int32 * 1)(int(ShaderKind.DAS))    # bad pipeline start
    assert lib.beamformer_push_pipeline(stages, 1, int(DataKind.Int16)) == 0
    kinds.append(lib.beamformer_get_last_error())
    sp = _fill_simple(mod)                            # data size mismatch
    assert lib.beamformer_push_simple_parameters(ct.byref(sp)) == 1
    assert _push(lib, raw) == 0
    kinds.append(lib.beamformer_get_last_error())
    assert lib.beamformer_push_simple_parameters_at(ct.byref(sp), 9) == 0
    kinds.append(lib.beamformer_get_last_error())     # unreserved block
    return kinds


def test_client_errors(server):
    assert _error_sequence(server.lib, abi) == [
        int(ErrorKind.InvalidImagePlane), int(ErrorKind.InvalidStartShader),
        int(ErrorKind.DataSizeMismatch),
        int(ErrorKind.ParameterBlockUnallocated)]


def _c_client(tmp_path) -> Path:
    """tests/test_ipc.py's C client, compiled against the port's generated
    header and linked against the port's library."""
    from ogl_beamforming_tpu_torch.params.codegen import write_generated
    gen = tmp_path / "gen"
    write_generated(gen)
    src = tmp_path / "client.c"
    src.write_text(r'''
#include "ogl_beamformer_lib.h"
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
int main(void) {
    if (beamformer_get_api_version() != 34) return 2;
    BeamformerSimpleParameters sp;
    memset(&sp, 0, sizeof sp);
    float eye[16] = {1,0,0,0, 0,1,0,0, 0,0,1,0, 0,0,0,1};
    /* 2D xz transform: lateral 0..2.1mm (col 0), axial 1..8mm (col 1) */
    float vt[16] = {0.0021f,0,0,0, 0,0,0.007f,0, 0,1,0,0, 0,0,0.001f,1};
    memcpy(sp.parameters.das_voxel_transform, vt, sizeof vt);
    memcpy(sp.parameters.xdc_transform, eye, sizeof eye);
    sp.parameters.xdc_element_pitch[0] = 0.0003f;
    sp.parameters.xdc_element_pitch[1] = 0.0003f;
    sp.parameters.raw_data_dimensions[0] = 4 * 256;
    sp.parameters.raw_data_dimensions[1] = 8;
    sp.parameters.sample_count = 256;
    sp.parameters.channel_count = 8;
    sp.parameters.acquisition_count = 4;
    sp.parameters.decode_mode = BeamformerDecodeMode_Hadamard;
    sp.parameters.single_focus = 1;
    sp.parameters.single_orientation = 1;
    sp.parameters.output_points[0] = 12;
    sp.parameters.output_points[1] = 16;
    sp.parameters.output_points[2] = 1;
    sp.parameters.sampling_frequency = 20e6f;
    sp.parameters.speed_of_sound = 1500.0f;
    sp.parameters.f_number = 0.8f;
    sp.parameters.interpolation_mode = BeamformerInterpolationMode_Linear;
    sp.parameters.decimation_rate = 1;
    for (int i = 0; i < 256; i++) sp.channel_mapping[i] = (int16_t)i;
    sp.compute_stages[0] = BeamformerShaderKind_Decode;
    sp.compute_stages[1] = BeamformerShaderKind_DAS;
    sp.compute_stages_count = 2;
    sp.data_kind = BeamformerDataKind_Int16;

    int16_t *data = malloc(8 * 4 * 256 * sizeof(int16_t));
    for (int i = 0; i < 8 * 4 * 256; i++) data[i] = (int16_t)((i * 2654435761u) >> 22);
    float *out = calloc(12 * 16, sizeof(float));
    if (!beamformer_beamform_data(&sp, data, 8*4*256*2, out, 30000)) {
        fprintf(stderr, "beamform failed: %s\n", beamformer_get_last_error_string());
        return 3;
    }
    float peak = 0;
    for (int i = 0; i < 12 * 16; i++) if (out[i] > peak || -out[i] > peak)
        peak = out[i] > 0 ? out[i] : -out[i];
    printf("PEAK %f\n", peak);
    return peak > 0 ? 0 : 4;
}
''')
    exe = tmp_path / "client"
    lib_dir = abi.build_native().parent
    subprocess.run(
        [abi.find_cc(), str(src), "-I", str(gen), "-L", str(lib_dir),
         "-logl_beamformer_tpu", "-o", str(exe)],
        check=True, capture_output=True, timeout=60)
    return exe


def test_cross_process_c_client(server, tmp_path):
    """A compiled C client in another process drives the port's server
    through the shared-memory ABI (the reference's tests/decode.c shape)."""
    exe = _c_client(tmp_path)
    env = dict(os.environ)
    env["LD_LIBRARY_PATH"] = str(abi.build_native().parent)
    env[SHM_ENV] = f"/bf_torch_test_{os.getpid()}"
    before = server.beamformer._frame_id
    result = subprocess.run([str(exe)], env=env, capture_output=True,
                            text=True, timeout=60)
    assert result.returncode == 0, (result.stdout, result.stderr)
    assert "PEAK" in result.stdout
    assert server.beamformer._frame_id == before + 1


def test_live_imaging_bridge(server):
    """Server-side live updates propagate to clients' dirty-flag poll."""
    lib = server.lib
    server.set_live(transmit_power=0.75, active=1,
                    dirty_flags=int(LiveImagingDirtyFlags.TransmitPower))
    live = lib.beamformer_get_live_parameters()
    assert abs(live.contents.transmit_power - 0.75) < 1e-6
    # client polls one flag at a time (lowest set)
    assert lib.beamformer_live_parameters_get_dirty_flag() == 1
    assert lib.beamformer_live_parameters_get_dirty_flag() == -1

    # client -> server direction
    live.contents.save_enabled = 1
    new = abi.CLiveImagingParameters()
    ct.memmove(ct.byref(new), live, ct.sizeof(new))
    new.transmit_power = 0.5
    assert lib.beamformer_set_live_parameters(ct.byref(new)) == 1
    assert abs(server.get_live().transmit_power - 0.5) < 1e-6


def test_multi_block_and_capacity_queries(server, rng):
    """Parameter-block reservation, _at variants, and capacity queries."""
    lib = server.lib
    assert lib.beamformer_reserve_parameter_blocks(3) == 1
    sp = _fill_simple(nx=8, nz=8)
    assert lib.beamformer_push_simple_parameters_at(ct.byref(sp), 2) == 1
    raw = rng.integers(-512, 512, (8, 4 * 256)).astype(np.int16)
    assert _push(lib, raw, block=2) == 1
    out = np.zeros(8 * 8, np.float32)
    assert lib.beamformer_get_last_frames(
        out.ctypes.data_as(ct.c_void_p), out.nbytes, 1) == 1
    assert np.abs(out).max() > 0
    assert 2 in server._sessions

    assert lib.beamformer_maximum_rf_data_size() > 1 << 20
    n = lib.beamformer_maximum_frames_for_parameters(ct.byref(sp.parameters))
    assert 0 < n < (1 << 63)
    assert lib.beamformer_push_simple_parameters_at(ct.byref(sp), 9) == 0
    assert lib.beamformer_get_last_error() == \
        int(ErrorKind.ParameterBlockUnallocated)


def test_queue_stress_sanitizers(tmp_path):
    """The multi-producer queue claim/commit protocol of the port's copy of
    beamformer_lib.c under TSan and ASan/UBSan (native/Makefile's
    ``stress`` target, built with the C compiler into a scratch
    directory)."""
    src = str(abi.NATIVE_DIR / "queue_stress.c")
    builds = {"queue_stress": ["-O2", "-g", "-Wall", "-std=c11", "-pthread"],
              "queue_stress_tsan": ["-O1", "-g", "-Wall", "-std=c11",
                                    "-pthread", "-fsanitize=thread"],
              "queue_stress_asan": ["-O1", "-g", "-Wall", "-std=c11",
                                    "-pthread",
                                    "-fsanitize=address,undefined"]}
    for exe, flags in builds.items():
        build = subprocess.run([abi.find_cc(), *flags, src, "-o",
                                str(tmp_path / exe)], capture_output=True,
                               text=True, timeout=120)
        if build.returncode != 0:
            pytest.skip(f"sanitizer toolchain unavailable: "
                        f"{build.stderr[-200:]}")
    for exe in builds:
        run = subprocess.run([str(tmp_path / exe)], capture_output=True,
                             text=True, timeout=120)
        assert run.returncode == 0, f"{exe}: {run.stdout} {run.stderr[-500:]}"


@pytest.mark.parametrize("kind", [DataKind.Float32Complex,
                                  DataKind.Int16Complex],
                         ids=lambda k: k.name)
def test_beamform_data_complex_wire(server, rng, kind):
    """C-ABI round trip with interleaved Float32Complex and Int16Complex raw
    data (tests/test_ipc.py's two cases)."""
    raw, rf = _wire(kind, rng)
    out = _beamform(server, abi, kind, raw)
    assert nrmse(_golden(rf), out) < 1e-3


def _stop_imaging_sequence(srv, mod, rng) -> list[int]:
    """tests/test_ipc.py::test_server_stop_imaging's calls on ``srv``: the
    frame count after a frame, after a frame pushed while stopped, and
    after one pushed on restart."""
    lib = srv.lib
    sp = _fill_simple(mod)
    assert lib.beamformer_push_simple_parameters(ct.byref(sp)) == 1
    raw = rng.integers(-512, 512, (8, 4 * 256)).astype(np.int16)
    assert _push(lib, raw) == 1
    out = np.zeros(12 * 16, np.float32)
    assert lib.beamformer_get_last_frames(
        out.ctypes.data_as(ct.c_void_p), out.nbytes, 1) == 1
    counts = [srv.beamformer._frame_id]
    # UI side requests stop: active = 0 + StopImaging dirty flag
    srv.set_live(dirty_flags=int(LiveImagingDirtyFlags.StopImaging),
                 active=0)
    assert _push(lib, raw) == 1            # accepted but dropped
    _flush(srv)
    time.sleep(0.2)
    counts.append(srv.beamformer._frame_id)
    srv.set_live(active=1)                 # restart
    assert _push(lib, raw) == 1
    _flush(srv)
    counts.append(_wait_frames(srv, counts[0] + 1))
    return counts


def test_server_stop_imaging(server, rng):
    """StopImaging halts the server's compute loop until active again
    (reference: live-control plumbing, tests/throughput.c:558-560)."""
    n0, stopped, restarted = _stop_imaging_sequence(server, abi, rng)
    assert stopped == n0 and restarted == n0 + 1


# ---------------------------------------------------------------------------
# The port's own: native copies, build, region size, device default
# ---------------------------------------------------------------------------

NATIVE_FILES = ["beamformer_abi.h", "beamformer_lib.c", "queue_stress.c",
                "win32_check.h", "Makefile"]


@pytest.mark.parametrize("name", NATIVE_FILES)
def test_native_sources_are_copies(name):
    ours = (abi.NATIVE_DIR / name).read_bytes()
    assert ours == (Path(jax_abi.NATIVE_DIR) / name).read_bytes()


def test_build_flags_are_the_makefiles():
    text = (abi.NATIVE_DIR / "Makefile").read_text()
    flags = {k: v.split() for k, v in
             (line.split("?=", 1) for line in text.splitlines()
              if line.startswith(("CFLAGS", "LDFLAGS")))}
    assert [k.strip() for k in flags] == ["CFLAGS", "LDFLAGS"]
    cflags, ldflags = flags.values()
    assert cflags == abi.CFLAGS and ldflags == abi.LDFLAGS


def test_library_named_by_its_sources(tmp_path, monkeypatch):
    """An edited source builds a library of its own; the link for C
    clients follows the newest build; the build lands in the given
    directory only."""
    native = tmp_path / "native"
    shutil.copytree(abi.NATIVE_DIR, native)
    monkeypatch.setattr(abi, "NATIVE_DIR", native)
    monkeypatch.setattr(abi, "BUILD_DIR", tmp_path / "build")
    first = abi.build_native()
    assert first.parent == tmp_path / "build" and first.exists()
    assert abi.build_native() == first                  # built once
    src = native / "beamformer_lib.c"
    src.write_text(src.read_text() + "\n/* edited */\n")
    second = abi.build_native()
    assert second != first and second.exists()
    link = tmp_path / "build" / "libogl_beamformer_tpu.so"
    assert os.readlink(link) == second.name
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [first.name, second.name, link.name])


def test_library_builds_into_the_ports_tree():
    path = abi.build_native()
    pkg = Path(abi.__file__).resolve().parent.parent
    assert path.parent == pkg / "_build" / "native"
    assert path == abi.library_path()
    ignored = (REPO / ".gitignore").read_text().split()
    assert "ogl_beamforming_tpu_torch/_build/" in ignored


def test_region_beyond_dev_shm_refused(monkeypatch):
    monkeypatch.setattr(server_mod, "shm_free_bytes", lambda: 1 << 20)
    with pytest.raises(BeamformerError) as e:
        BeamformerServer(shm_size=64 << 20, device="cpu")
    assert e.value.kind == ErrorKind.SharedMemory
    assert str(64 << 20) in str(e.value) and str(1 << 20) in str(e.value)


def test_server_defaults_to_the_gpu():
    """``BeamformerServer()`` runs on the card, and raises without one
    before it creates a region."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        BeamformerServer(shm_size=64 << 20)


def test_parameters_round_trip_through_c():
    """``simple_parameters_to_c`` (``parameters_to_c``, the pipeline, the
    identity mapping) and the server's ``_parameters_from_c``: every field
    of a preset's parameters comes back as its float32 value."""
    from ogl_beamforming_tpu_torch.models import presets
    for p, pipe in (presets.forces_compounding(), presets.plane_wave_2d(),
                    presets.hercules_3d()):
        sp = server_mod.simple_parameters_to_c(p, pipe.shaders,
                                               pipe.data_kind)
        n = sp.compute_stages_count
        assert list(sp.compute_stages[:n]) == [int(k) for k in pipe.shaders]
        assert sp.data_kind == int(pipe.data_kind)
        assert list(sp.channel_mapping) == list(range(256))
        back = server_mod._parameters_from_c(sp.parameters)
        for name, value in vars(p).items():
            got = getattr(back, name)
            if name == "emission_parameters":
                assert int(got.kind) == int(value.kind)
                continue
            want = np.asarray(value)
            if want.dtype.kind == "f":
                want = want.astype(np.float32)
            assert np.array_equal(np.asarray(got, want.dtype), want), name


@pytest.mark.parametrize("kind", [DataKind.Int16, DataKind.Int16Complex,
                                  DataKind.Float32Complex],
                         ids=lambda k: k.name)
def test_served_frames_equal_push_data_with_compute(server, rng, kind):
    """Five frames of each wire kind pushed in a row and read back at once
    equal the executor's ``push_data_with_compute`` of each, bit for bit;
    the stats table the client reads holds a row for each."""
    lib = server.lib
    sp = _fill_simple()
    sp.data_kind = int(kind)
    assert lib.beamformer_push_simple_parameters(ct.byref(sp)) == 1
    raws = [_wire(kind, rng)[0] for _ in range(5)]
    server._drain_sessions()     # the rows of frames earlier tests left
    rows0 = server.beamformer.stats._frame_index
    for raw in raws:
        assert _push(lib, raw) == 1
    out = np.zeros((5, 12 * 16),
                   np.float32 if kind == DataKind.Int16 else np.complex64)
    assert lib.beamformer_get_last_frames(
        out.ctypes.data_as(ct.c_void_p), out.nbytes, 5) == 1
    assert server.beamformer.stats._frame_index == rows0 + 5
    stats = abi.CStatsTable()
    assert lib.beamformer_compute_timings(ct.byref(stats), 1000) == 1
    times = np.ctypeslib.as_array(stats.times)
    assert np.array_equal(times, server.beamformer.stats.table.times)
    ref = Beamformer(device="cpu")
    b = server.beamformer._blocks[0]
    ref.push_parameters(b.parameters)
    ref.push_pipeline([s.kind for s in b.pipeline.stages],
                      b.pipeline.data_kind)
    for raw, got in zip(raws, out):
        want = ref.push_data_with_compute(raw).to_reference_layout()
        assert np.array_equal(want, got)


# ---------------------------------------------------------------------------
# The JAX server and the port's, on the same client calls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", [DataKind.Int16, DataKind.Int16Complex,
                                  DataKind.Float32Complex],
                         ids=lambda k: k.name)
def test_frames_match_the_jax_server(server, jax_server, rng, kind):
    raw, rf = _wire(kind, rng)
    ours = _beamform(server, abi, kind, raw)
    theirs = _beamform(jax_server, jax_abi, kind, raw)
    assert nrmse(theirs, ours) <= 1e-4
    assert nrmse(_golden(rf), ours) <= 1e-3


def test_error_kinds_match_the_jax_server(server, jax_server):
    ours = _error_sequence(server.lib, abi)
    assert ours == _error_sequence(jax_server.lib, jax_abi)
    assert [server.lib.beamformer_error_string(k) for k in ours] == \
        [jax_server.lib.beamformer_error_string(k) for k in ours]


def test_stop_imaging_matches_the_jax_server(server, jax_server, rng):
    ours = _stop_imaging_sequence(server, abi, rng)
    theirs = _stop_imaging_sequence(jax_server, jax_abi, rng)
    assert np.diff(ours).tolist() == np.diff(theirs).tolist() == [0, 1]
    assert server._imaging_stopped == jax_server._imaging_stopped is False
