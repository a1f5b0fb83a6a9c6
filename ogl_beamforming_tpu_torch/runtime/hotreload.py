"""Developer hot-reload: the torch counterpart of
``ogl_beamforming_tpu.runtime.hotreload``.  Watch the op sources and the
CUDA sources, reload what changed, and invalidate the plans built from them.

The analogue of the reference's inotify shader watching + library
hot-reload (main_linux.c:206-255,342-365, beamformer_core.c:1799-1853):
edited GLSL marked pipelines dirty and recompiled on the next frame.  Here
the watched units are the Python op modules and ``csrc/``.  A changed
module is reloaded; a changed CUDA source clears ``kernels/build.library``'s
cache, so the next launch builds and loads the library of the new sources
(its file is named by their hash).  Either way every executor block is
marked dirty and drops its plans, so the next frame plans against the new
code; state (parameter blocks, backlog, stats) survives, exactly like the
reference's reload keeping memory in the platform layer.  The port runs
eagerly and keeps no jit or plan cache to clear (``pipeline/plan.py``).
"""

from __future__ import annotations

import importlib
import sys
import threading
from pathlib import Path

from ..kernels import build

_WATCHED_MODULES = [
    "ogl_beamforming_tpu_torch.ops.decode",
    "ogl_beamforming_tpu_torch.ops.filtering",
    "ogl_beamforming_tpu_torch.ops.das",
    "ogl_beamforming_tpu_torch.ops.das_cuda",
    "ogl_beamforming_tpu_torch.ops.coherency",
    "ogl_beamforming_tpu_torch.ops.display",
    "ogl_beamforming_tpu_torch.pipeline.plan",
]


def invalidate_compiled(beamformers=(), kernels: bool = False):
    """Dirty every executor block and drop its plans and its device copy of
    the channel mapping (the reload's ``dirty_programs`` sweep,
    beamformer_core.c:1818-1845); with ``kernels``, also forget the loaded
    CUDA library so that the next launch builds the current sources."""
    if kernels:
        build.library.cache_clear()
    for bf in beamformers:
        for block in bf._blocks:
            block.mark_dirty()
            block._plan = None
            block._batched_plans.clear()
            block._rows = None


def reload_ops(beamformers=(), names=None):
    """Reload the given op modules (all watched ones by default) then
    invalidate compiled state."""
    for name in (names if names is not None else _WATCHED_MODULES):
        if name in sys.modules:
            importlib.reload(sys.modules[name])
    invalidate_compiled(beamformers)


class SourceWatcher:
    """Poll-based watcher over the op sources and ``csrc/`` (the inotify
    analogue)."""

    def __init__(self, beamformers=(), interval: float = 0.5,
                 on_reload=None):
        self.beamformers = list(beamformers)
        self.interval = interval
        self.on_reload = on_reload
        self._mtimes: dict[Path, float] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        for _, path in self._paths():
            self._mtimes[path] = path.stat().st_mtime

    def _paths(self):
        """(module name or None for a CUDA source, path) of every watched
        file."""
        for name in _WATCHED_MODULES:
            mod = sys.modules.get(name) or importlib.import_module(name)
            yield name, Path(mod.__file__)
        for path in sorted(build.CSRC_DIR.glob("*.cu*")):
            yield None, path

    def poll_once(self) -> bool:
        """Check mtimes; reload changed modules, and the CUDA library if a
        source of it changed.  Returns True if anything changed (only the
        edited modules reload — the analogue of the reference's per-shader
        dirty bits)."""
        changed, kernels = [], False
        for name, path in self._paths():
            mtime = path.stat().st_mtime
            if mtime != self._mtimes.get(path):
                self._mtimes[path] = mtime
                if name is None:
                    kernels = True
                else:
                    changed.append(name)
        if changed:
            reload_ops(self.beamformers, changed)
        if kernels:
            invalidate_compiled(self.beamformers, kernels=True)
        if (changed or kernels) and self.on_reload:
            self.on_reload()
        return bool(changed) or kernels

    def start(self):
        def loop():
            while not self._stop.is_set():
                try:
                    self.poll_once()
                except Exception:
                    pass
                self._stop.wait(self.interval)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="beamformer-hotreload")
        self._thread.start()
        return self

    def stop(self, timeout: float = 2.0):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=timeout)
