"""The port's hot reload (``ogl_beamforming_tpu_torch.runtime.hotreload``):
``tests/test_hotreload.py`` mirrored on ``Beamformer(device="cpu")``, and a
change under ``csrc/`` forgetting the loaded CUDA library.  The watcher
tests change a source's modification time, never its content, and put it
back."""

import os
from contextlib import contextmanager

import numpy as np
import pytest

from ogl_beamforming_tpu.runtime import hotreload as jax_hotreload
from ogl_beamforming_tpu_torch.kernels import build
from ogl_beamforming_tpu_torch.params.enums import (AcquisitionKind,
                                                    DataKind,
                                                    InterpolationMode,
                                                    ShaderKind)
from ogl_beamforming_tpu_torch.params.types import Parameters
from ogl_beamforming_tpu_torch.pipeline.executor import Beamformer
from ogl_beamforming_tpu_torch.runtime import hotreload
from ogl_beamforming_tpu_torch.runtime.hotreload import (SourceWatcher,
                                                         invalidate_compiled)
from ogl_beamforming_tpu_torch.utils.transforms import das_transform_2d_xz


def _bf(rng):
    pitch = 0.3e-3
    p = Parameters(
        sample_count=256, channel_count=8, acquisition_count=4,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, f_number=0.8,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Linear,
        das_voxel_transform=das_transform_2d_xz([0, 1e-3],
                                                [7 * pitch, 8e-3]),
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        output_points=np.array([12, 16, 1, 0], np.int32))
    bf = Beamformer(device="cpu")
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    bf.push_data_with_compute(
        rng.integers(-512, 512, (8, 4 * 256)).astype(np.int16))
    return bf


@contextmanager
def _touched(path):
    """``path``'s modification time one second later, then put back."""
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    try:
        yield
    finally:
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))


def test_invalidate_compiled(rng):
    bf = _bf(rng)
    bf.push_batch(rng.integers(-512, 512, (2, 8, 4 * 256)).astype(np.int16))
    from ogl_beamforming_tpu_torch.runtime.streaming import StreamingSession
    with StreamingSession(bf) as s:      # the device ingest keeps _rows
        s.submit(np.zeros((8, 4 * 256), np.int16)).result(timeout=30)
    b = bf._blocks[0]
    assert not b.dirty and b._batched_plans and b._rows is not None
    invalidate_compiled([bf])
    assert b.dirty and b._plan is None
    assert not b._batched_plans and b._rows is None
    # recompute works after invalidation
    f = bf.push_data_with_compute(
        rng.integers(-512, 512, (8, 4 * 256)).astype(np.int16))
    assert f.output_points == (12, 16, 1)


def test_watcher_detects_touch(rng):
    bf = _bf(rng)
    w = SourceWatcher([bf], interval=0.05)
    assert not w.poll_once()
    import ogl_beamforming_tpu_torch.ops.decode as decode_mod
    with _touched(decode_mod.__file__):
        assert w.poll_once()
    assert bf._blocks[0].dirty
    # pipeline still works post-reload
    f = bf.push_data_with_compute(np.zeros((8, 4 * 256), np.int16))
    assert f.output_points == (12, 16, 1)


class _Library:
    """Stands in for ``build.library`` (an lru_cache): counts clears."""

    def __init__(self):
        self.cleared = 0

    def cache_clear(self):
        self.cleared += 1


def test_watcher_forgets_the_library_on_a_cuda_source_change(rng,
                                                            monkeypatch):
    """A changed ``csrc/`` file clears ``build.library``'s cache (the next
    launch builds the new sources, whose library has another name) and
    dirties every block, without reloading a module."""
    lib = _Library()
    monkeypatch.setattr(build, "library", lib)
    reloaded = []
    monkeypatch.setattr(hotreload, "reload_ops",
                        lambda bfs, names=None: reloaded.append(names))
    bf = _bf(rng)
    w = SourceWatcher([bf], interval=0.05)
    assert not w.poll_once()
    with _touched(build.CSRC_DIR / "filter.cu"):
        assert w.poll_once()
        assert not w.poll_once()
    assert lib.cleared == 1 and not reloaded
    assert bf._blocks[0].dirty and bf._blocks[0]._plan is None


def test_watcher_threads_stop(rng):
    w = SourceWatcher([_bf(rng)], interval=0.01).start()
    w.stop(timeout=5)
    assert not w._thread.is_alive()


@pytest.mark.parametrize("kernels", [False, True])
def test_invalidate_clears_the_library_only_when_asked(rng, monkeypatch,
                                                      kernels):
    lib = _Library()
    monkeypatch.setattr(build, "library", lib)
    invalidate_compiled([_bf(rng)], kernels=kernels)
    assert lib.cleared == int(kernels)


def test_watched_modules_are_the_ports_of_jaxs():
    """The JAX package's watched op modules, with ``das_pallas`` (its DAS
    kernel) as the port's ``das_cuda``."""
    want = [n.replace("ogl_beamforming_tpu.", "ogl_beamforming_tpu_torch.")
            .replace("das_pallas", "das_cuda")
            for n in jax_hotreload._WATCHED_MODULES]
    assert hotreload._WATCHED_MODULES == want
