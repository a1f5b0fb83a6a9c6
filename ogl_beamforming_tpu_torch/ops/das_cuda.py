"""CUDA launch of the DAS kernels: the torch counterpart of the parts of
``ogl_beamforming_tpu.ops.das_pallas`` that the port's paths need.

:func:`prepare` is the analogue of ``das_pallas._prep_scalars``: it packs the
dynamic parameters into the kernel's scalar vector.  A FORCES- or
HERCULES-family frame also gets its per-transmit tables
(``das.transmit_tables``: FORCES element x positions; READI Hadamard-row
weights with rf acquisition ``e % A``; UFORCES and UHERCULES
``sparse_elements``, skipping acquisition 0; HERCULES row or column
positions with the first transmit's ``1/sqrt(A)`` weight), a HERCULES
frame's sorted by position (:func:`sorted_transmits`); an RCA or HERCULES
frame gets the per-acquisition transmit table (``das.rca_tables``, of which
HERCULES reads acquisition 0) and the run of voxels that share their
lateral coordinates (:func:`lateral_run`).  The tables stay on the device; a
FORCES-family frame also reads its voxel spacing and sampling rate on the
host once, to choose the pass length of the kernel's index table
(:func:`index_table_pass`).  :func:`launch_tables` gathers them;
they depend only on the plan, so ``build_plan`` builds them once into
``dyn["launch"]`` and a frame reuses them.  :func:`das_cuda` checks its
inputs, allocates the outputs and launches ``csrc/das.cu`` on the current
stream: one launch for a frame, and for a batch of B frames B // 4 launches
of the four-frame instantiation and B % 4 of the single-frame one.

The launch knobs -- the FORCES index table's pass (``tx_pass``), the
HERCULES walk (``tx_walk``), the HERCULES and RCA thread shape
(``thread``) and a batch's frames a launch (``fb``) -- are chosen per
configuration under ``das_pallas``'s names: :data:`ABLATE` (an explicit
override), then :data:`TUNED` (installed by :func:`autotune_das` or
:func:`load_tuned`, and the shipped H100 table ``data/tuned_h100.json``,
loaded once on first use), then the measured defaults.
:func:`launch_tables` reads them, so a plan launches the knobs installed
when it was built.
"""

from __future__ import annotations

import ctypes
import json
from pathlib import Path

import torch

from ..kernels import build
from ..params.enums import InterpolationMode
from ..utils import device as device_utils
from .das import DasStatic, rca_tables, transmit_tables

_MODE = {InterpolationMode.Nearest: 0, InterpolationMode.Linear: 1,
         InterpolationMode.Cubic: 2}
# csrc/das.cu's Family codes
_FAMILY = {"forces": 0, "hercules": 1, "rca": 2}
FRAMES_PER_LAUNCH = 4
"""Frames of a batch that one launch of the batched instantiations takes."""
MAX_FORCES_TRANSMITS = 2048
"""Most transmits a FORCES-family launch takes (``csrc/das.cu``
``kMaxTransmits``): its per-transmit table shares 48 KB of shared memory
with the index table."""
WIDE_PASS, NARROW_PASS = 32, 8
"""Transmits per pass of the FORCES kernel's index table (16 or 4 KB of
shared memory a block)."""
MAX_TX_PASS = 32
"""Most transmits a pass takes (``csrc/das.cu`` ``kMaxTxChunk``)."""
SCATTERED_BYTES = 512
"""A warp's 32 neighbouring voxels whose samples may lie further apart than
this (four 128-byte lines of one rf row) take the narrow pass, which leaves
L1 more room for their gathers."""
INTERVAL_WALK, FULL_WALK = 1, 0
"""The HERCULES kernel's walk over a channel's transmits: the interval of
those that can pass the mask, or the whole table (``tx_walk``)."""
KNOBS = {"tx_pass": ("forces",), "tx_walk": ("hercules",),
         "thread": ("hercules", "rca"), "fb": ("forces", "hercules", "rca")}
"""Each launch knob and the families whose kernels have it (``fb`` only
for a frame batch).  Each changes the schedule only, and every voxel's
output stays bit-equal to the defaults', except ``tx_pass``: the FORCES
kernel sums a voxel's pairs one pass of the index table at a time (a
channel's transmits of the pass, then the next pass), so another pass
rounds the sum otherwise, within the twin bound (NRMSE 1e-4); and FORCES
``fb``, held to 1e-6 as before: that kernel's pair sums are not rounded
explicitly, so its four-frame instantiation may be contracted otherwise."""
TUNED_PATH = (Path(__file__).resolve().parent.parent / "data"
              / "tuned_h100.json")
"""The shipped table, made on an H100 by ``python -m
ogl_beamforming_tpu_torch.pretune``."""
ABLATE: dict = {}
"""Knobs that override every table (experiments)."""
TUNED: dict = {}
"""Per-configuration knobs keyed by :func:`_tune_key`."""
_SHIPPED_TUNED_LOADED = False
TWO_PI_SPLIT = tuple(float.fromhex(h) for h in (
    "0x1.921fb6p+2", "-0x1.777a5cp-23", "-0x1.ee59dap-48"))
"""2 pi as float32 hi, mid and lo parts, whose sum is 2 pi to about 1e-22:
the exact reduction of the HERCULES and RCA kernels' phase argument
(``csrc/das.cu`` ``kTwoPiHi``, ``kTwoPiMid``, ``kTwoPiLo``)."""


def prepare(dyn: dict) -> torch.Tensor:
    """The kernel's scalar vector, ``csrc/das.cu``'s ``Scalar`` layout:
    voxel transform rows 0..2, fs, c, t0, f#, pitch x, pitch y, f_demod,
    channel offset, x offset, XDC transform rows 0..2."""
    f32 = torch.float32
    return torch.cat([
        dyn["voxel_transform"][:3].reshape(-1).to(f32),
        torch.stack([dyn["sampling_frequency"], dyn["speed_of_sound"],
                     dyn["time_offset"], dyn["f_number"]]).to(f32),
        dyn["xdc_element_pitch"][:2].to(f32),
        torch.stack([dyn["demodulation_frequency"].to(f32),
                     dyn["channel_offset"].to(f32),
                     dyn["x_offset"].to(f32)]),
        dyn["xdc_transform"][:3].reshape(-1).to(f32),
    ]).contiguous()


def index_table_pass(st: DasStatic, dyn: dict) -> int:
    """Transmits per pass of the FORCES kernel's index table.  The receive
    terms are recomputed once a pass, so the wide pass costs less
    arithmetic; but its shared memory is taken from L1, which the gathers
    need when a warp's voxels read samples far apart.  A warp holds 32
    voxels neighbouring along the fastest axis of the grid that has more
    than one point; the sample index moves at most 2 fs / c per metre of
    their spacing (each leg's distance at most as fast as the voxel), so
    ``32 x 2 x step x fs / c`` samples bound the warp's spread.  Measured on
    an H100 (``chip_smoke.py`` prints both passes): the Quickstart's 2D grid
    (357 bytes) runs faster with the wide pass, path D's 128^3 volume (1047
    bytes) with the narrow one."""
    points = st.global_points or st.output_points
    axis = next((k for k in (2, 1, 0) if points[k] > 1), 2)
    column = dyn["voxel_transform"][:3, axis].double().cpu()
    step = float(torch.linalg.vector_norm(column)) / max(points[axis] - 1, 1)
    rate = float(dyn["sampling_frequency"]) / float(dyn["speed_of_sound"])
    spread = 32 * 2.0 * step * rate * (8 if st.iq else 4)
    return NARROW_PASS if spread > SCATTERED_BYTES else WIDE_PASS


def _run_axis(st: DasStatic) -> int | None:
    """The fastest axis of the output grid with more than one point: a
    thread's neighbours lie along it."""
    return next((k for k in (2, 1, 0) if st.output_points[k] > 1), None)


def lateral_uniform(dyn: dict, axis: int) -> bool:
    """Whether the XDC-space lateral coordinates (x and y) of a voxel are
    bit-equal along grid ``axis``: each of their terms ``xdc[i, j] *
    world_j`` has a zero transform coefficient or a world coordinate that
    does not move along the axis (``voxel[j, axis] == 0``).  A product with
    a zero coefficient is +-0 and adds nothing; a lateral coordinate of +-0
    gives the same squares and absolute values."""
    vt = dyn["voxel_transform"].detach().cpu()
    xt = dyn["xdc_transform"].detach().cpu()
    return all(bool(xt[i, j] == 0) or bool(vt[j, axis] == 0)
               for i in (0, 1) for j in range(3))


def lateral_run(st: DasStatic, dyn: dict) -> int:
    """Consecutive voxels (C order) that share their XDC lateral
    coordinates: the points along the grid's fastest axis with more than one
    point where :func:`lateral_uniform` holds along it (HERCULES 3D: a
    column of depths; a 2D plane-wave grid: a line of depths), else 1.  The
    HERCULES and RCA kernels compute the lateral geometry once per thread's
    voxels of a run."""
    axis = _run_axis(st)
    if axis is None or not lateral_uniform(dyn, axis):
        return 1
    return st.output_points[axis]


def sorted_transmits(st: DasStatic, dyn: dict):
    """A HERCULES-family frame's per-transmit ``(position, weight, rf
    acquisition)`` (``das.transmit_tables``) in ascending position, ties in
    table order: the kernel searches the positions for the transmits a
    channel's mask can pass.  UHERCULES ``sparse_elements`` may come in any
    order."""
    tx_pos, weight, row = transmit_tables(st, dyn)
    order = torch.argsort(tx_pos, stable=True)
    return tx_pos[order], weight[order], row[order]


def _tune_key(st: DasStatic) -> tuple:
    """The key of ``st``'s entry in :data:`TUNED`: ``das_pallas._tune_key``'s
    tuple, whose channels are the launch's own (``st.local_channels``: a
    channel shard's count, the whole count for an unsharded plan), with
    ``("fb", B)`` appended only for a frame batch."""
    key = (st.family, int(st.interpolation_mode), st.iq,
           st.acquisition_count, st.local_channels, st.sample_count,
           tuple(st.output_points))
    if st.frame_batch > 1:
        key = key + (("fb", st.frame_batch),)
    return key


def check_knobs(key: tuple, knobs: dict) -> dict:
    """``knobs`` if each is a knob of the kernel of ``key``'s family (a
    :func:`_tune_key`) with a value it takes; ``ValueError`` otherwise: a
    table of another package's knobs fails here, it is not ignored."""
    family, batched = key[0], len(key) > 7
    for name, value in knobs.items():
        if name not in KNOBS:
            raise ValueError(f"unknown DAS knob {name!r} (the port's: "
                             f"{', '.join(KNOBS)})")
        if family not in KNOBS[name] or (name == "fb" and not batched):
            raise ValueError(f"knob {name!r} does not apply to {key}")
    if not 1 <= knobs.get("tx_pass", 1) <= MAX_TX_PASS:
        raise ValueError(f"tx_pass {knobs['tx_pass']} outside 1.."
                         f"{MAX_TX_PASS}")
    if knobs.get("tx_walk", INTERVAL_WALK) not in (INTERVAL_WALK, FULL_WALK):
        raise ValueError(f"tx_walk {knobs['tx_walk']} is not "
                         f"{INTERVAL_WALK} or {FULL_WALK}")
    fb = knobs.get("fb", FRAMES_PER_LAUNCH)
    if fb not in (1, FRAMES_PER_LAUNCH):
        raise ValueError(f"fb {fb} is not 1 or {FRAMES_PER_LAUNCH}")
    if "thread" in knobs:
        shape = tuple(knobs["thread"])
        if shape not in build.THREAD_SHAPES[family]:
            raise ValueError(f"thread {list(shape)} is not one of "
                             f"{build.THREAD_SHAPES[family]} ({family})")
        if batched and fb != 1 and shape != build.THREAD_SHAPES[family][0]:
            raise ValueError(f"thread {list(shape)}: the other shapes are "
                             f"instantiated for single-frame launches only")
    return knobs


def _key_from_json(k: list) -> tuple:
    return (k[0], k[1], k[2], k[3], k[4], k[5], tuple(k[6])) + tuple(
        tuple(x) for x in k[7:])


def _table_rows(path) -> list:
    """The (key, knobs) rows of a :func:`save_tuned` table, every row
    checked before any is installed."""
    with open(path) as f:
        rows = json.load(f)
    out = []
    for row in rows:
        key = _key_from_json(row["key"])
        out.append((key, check_knobs(key, dict(row["knobs"]))))
    return out


def _load_shipped_tuned() -> None:
    """Install the shipped table once, lazily, without overriding entries
    the user installed."""
    global _SHIPPED_TUNED_LOADED
    if _SHIPPED_TUNED_LOADED:
        return
    _SHIPPED_TUNED_LOADED = True
    if not TUNED_PATH.exists():
        return
    for key, knobs in _table_rows(TUNED_PATH):
        TUNED.setdefault(key, knobs)


def save_tuned(path) -> None:
    """Write :data:`TUNED` as JSON rows ``{"key": [...], "knobs": {...}}``
    (the JAX package's format)."""
    with open(path, "w") as f:
        json.dump([{"key": list(k), "knobs": v} for k, v in TUNED.items()],
                  f, indent=1)


def load_tuned(path) -> None:
    """Install a :func:`save_tuned` table (plans built after it launch its
    knobs); raises, installing nothing, on a knob the port's kernels do not
    have, such as the JAX package's TPU tables."""
    TUNED.update(_table_rows(path))


def _knob(st: DasStatic, name: str, default):
    """Knob ``name`` of ``st``: :data:`ABLATE`, then ``st``'s
    :data:`TUNED` entry, then ``default``."""
    if name in ABLATE:
        return ABLATE[name]
    _load_shipped_tuned()
    entry = TUNED.get(_tune_key(st))
    if entry is not None and name in entry:
        return entry[name]
    return default


def launch_tables(st: DasStatic, dyn: dict) -> dict:
    """The kernel's scalar vector and the tables of ``st``'s family, as
    contiguous device tensors: ``rca`` (A, 8), ``run``
    (:func:`lateral_run`) and ``thread``, the thread shape, for an RCA or
    HERCULES frame; ``tx_pos``, ``tx_weight`` and ``tx_row`` for a FORCES-
    or HERCULES-family frame (HERCULES: in ascending position, with
    ``tx_walk``, the kernel's walk); for a FORCES-family frame ``tx_pass``,
    the index table's pass (:func:`index_table_pass` by default); and for
    a frame batch ``fb``, its frames a launch.  The knobs are :func:`_knob`'s
    for ``st``."""
    tables = {"scalars": prepare(dyn)}
    if st.family in ("rca", "hercules"):
        tables["rca"] = rca_tables(dyn)
        tables["run"] = lateral_run(st, dyn)
        tables["thread"] = tuple(_knob(st, "thread",
                                       build.THREAD_SHAPES[st.family][0]))
    if st.family in ("forces", "hercules"):
        tx_pos, weight, row = (sorted_transmits(st, dyn)
                               if st.family == "hercules"
                               else transmit_tables(st, dyn))
        tables["tx_pos"] = tx_pos.to(torch.float32).contiguous()
        tables["tx_weight"] = weight.to(torch.float32).contiguous()
        tables["tx_row"] = row.to(torch.int32).contiguous()
    if st.family == "hercules":
        tables["tx_walk"] = _knob(st, "tx_walk", INTERVAL_WALK)
    if st.family == "forces":
        tables["tx_pass"] = _knob(st, "tx_pass", None) or index_table_pass(
            st, dyn)
    if st.frame_batch > 1:
        tables["fb"] = _knob(st, "fb", FRAMES_PER_LAUNCH)
    return tables


def launch_name(st: DasStatic, frames: int = 1) -> str:
    """The :data:`build.LAUNCHES` key of a launch of ``frames`` frames of
    ``st``'s family: ``das_forces``, ``das_hercules``, ``das_rca``, and
    ``..._fb4`` for the four-frame instantiation."""
    return f"das_{st.family}" + (f"_fb{frames}" if frames > 1 else "")


def _thread_args(st: DasStatic, thread=None) -> tuple:
    """The C entry points' (voxels, lanes, runs first): ``thread`` or the
    family's default shape (FORCES: ignored)."""
    if thread is None:
        thread = build.THREAD_SHAPES.get(st.family, ((1, 1, 0),))[0]
    return tuple(int(v) for v in thread)


def blocks_per_sm(st: DasStatic, n_tx: int, tx_pass: int = WIDE_PASS,
                  frames: int = 1, thread=None, device="cuda") -> int:
    """Blocks of 128 voxels that one SM of ``device`` (default: the
    current card) holds at once for the kernel of ``st`` with ``n_tx``
    transmits (or acquisitions) and, for FORCES, an index table of
    ``tx_pass`` transmits, for HERCULES and RCA in thread shape ``thread``
    (default: the family's): the occupancy its registers and shared memory
    allow (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    blocks = ctypes.c_int(0)
    lib = build.library()
    with device_utils.on_device(device):
        code = lib.das_occupancy(
            _FAMILY[st.family], _MODE[st.interpolation_mode], int(st.iq),
            int(st.coherency_weighting), frames, n_tx, tx_pass,
            *_thread_args(st, thread), ctypes.byref(blocks))
    build.check("das_occupancy", code)
    return blocks.value


def _chunks(batch: int, per_launch: int = FRAMES_PER_LAUNCH):
    """(first frame, frames) of each launch of a batch, ``per_launch``
    (1 or :data:`FRAMES_PER_LAUNCH`) frames a launch where they fill one."""
    start = 0
    while per_launch > 1 and batch - start >= per_launch:
        yield start, per_launch
        start += per_launch
    for i in range(start, batch):
        yield i, 1


def das_cuda(rf: torch.Tensor, dyn: dict, st: DasStatic):
    """Launch the DAS kernel of ``st``'s family on ``rf``, on the card that
    holds it: one frame
    (C, A, S), or (B, C, A, S) when ``st.frame_batch = B > 1``; contiguous
    float32, or complex64 when ``st.iq``, on a CUDA device that also holds
    ``dyn``.  Returns the (nx, ny, nz) volume, or (B, nx, ny, nz), or
    ``(coherent, incoherent)`` of those with coherency weighting.  The
    tables come from ``dyn["launch"]`` where the plan built them, else from
    ``dyn``."""
    if st.family not in _FAMILY:
        raise ValueError(f"CUDA DAS has no kernel for "
                         f"{st.acquisition_kind.name} (family {st.family!r})")
    if not rf.is_cuda:
        raise ValueError(f"das_cuda needs a CUDA tensor, got {rf.device}")
    want = torch.complex64 if st.iq else torch.float32
    if rf.dtype != want:
        raise ValueError(f"rf dtype {rf.dtype}, expected {want}")
    batch = st.frame_batch
    lead = (batch,) if batch > 1 else ()
    want_shape = lead + ("C", st.acquisition_count, st.sample_count)
    if rf.dim() != len(want_shape) or tuple(rf.shape[:len(lead)]) != lead \
            or rf.shape[-1] != st.sample_count \
            or rf.shape[-2] < st.acquisition_count:
        raise ValueError(f"rf shape {tuple(rf.shape)} does not match "
                         f"{want_shape}")
    if not rf.is_contiguous():
        raise ValueError("rf must be contiguous")
    tables = dyn.get("launch") or launch_tables(st, dyn)
    scalars = tables["scalars"]
    if scalars.device != rf.device:
        raise ValueError(f"dyn on {scalars.device}, rf on {rf.device}")

    channels, rf_rows, samples = rf.shape[-3:]
    nx, ny, nz = st.output_points
    gnx, gny, gnz = st.global_points or st.output_points
    out = torch.empty(lead + (nx, ny, nz), dtype=want, device=rf.device)
    inco = (torch.empty(lead + (nx, ny, nz), dtype=torch.float32,
                        device=rf.device)
            if st.coherency_weighting else None)
    if st.family == "rca":
        n_tx = st.acquisition_count
        tx = (None, None, None)
    else:
        n_tx = tables["tx_pos"].shape[0]
        if st.family == "forces" and n_tx > MAX_FORCES_TRANSMITS:
            raise ValueError(f"the FORCES DAS kernel takes at most "
                             f"{MAX_FORCES_TRANSMITS} transmits, got {n_tx}")
        tx = tuple(tables[k].data_ptr()
                   for k in ("tx_pos", "tx_weight", "tx_row"))
    tab = tables["rca"].data_ptr() if "rca" in tables else None
    flags = (_MODE[st.interpolation_mode], int(st.iq),
             int(st.coherency_weighting))
    # byte strides of one frame of rf, out and inco
    rf_frame = channels * rf_rows * samples * rf.element_size()
    out_frame = nx * ny * nz * out.element_size()
    inco_frame = nx * ny * nz * 4
    lib = build.library()
    thread = _thread_args(st, tables.get("thread"))
    for first, frames in _chunks(batch, tables.get("fb", FRAMES_PER_LAUNCH)):
        with device_utils.on_device(rf):
            code = lib.das_launch(
                _FAMILY[st.family], rf.data_ptr() + first * rf_frame,
                scalars.data_ptr(), tab, *tx,
                out.data_ptr() + first * out_frame,
                None if inco is None else inco.data_ptr() + first * inco_frame,
                channels, st.channel_count, rf_rows, samples, n_tx,
                nx, ny, nz, gnx, gny, gnz, *flags, frames,
                tables.get("tx_pass", WIDE_PASS), tables.get("run", 1),
                tables.get("tx_walk", INTERVAL_WALK), *thread,
                device_utils.launch_stream(rf))
        name = launch_name(st, frames)
        build.check(name, code)
        build.count_launch(name, f"das_{st.family}_kernel", variant=(
            "thread {}.{}.{}".format(*thread)
            if st.family in build.THREAD_SHAPES else None))
    if st.coherency_weighting:
        return out, inco
    return out


def _default_candidates(st: DasStatic) -> list:
    """The knob sets :func:`autotune_das` times for ``st``, the measured
    defaults (``{}``) first: for a frame batch, single-frame launches
    against launches of four (the counterpart of ``fb_pack``); FORCES,
    index-table passes of 8, 16 and 32 transmits; HERCULES and RCA, each
    other thread shape.  (The full HERCULES walk, a knob for experiments,
    lost to the interval walk in every case pretune ran.)"""
    if st.frame_batch > 1:
        return [{}, {"fb": 1}]
    if st.family == "forces":
        return [{}] + [{"tx_pass": p} for p in (NARROW_PASS, 16, WIDE_PASS)]
    return [{}] + [{"thread": list(t)}
                   for t in build.THREAD_SHAPES[st.family][1:]]


def autotune_das(rf, dyn: dict, st: DasStatic, candidates=None,
                 iters: int = 4, warmup: int = 1, save_path=None,
                 passes: int = 2, verbose: bool = False):
    """Time knob sets for ``st`` (default :func:`_default_candidates`) on
    ``rf`` with CUDA events and install the fastest in :data:`TUNED`, as
    ``das_pallas.autotune_das`` does for the TPU kernel: plans built after
    it launch those knobs.  Each candidate runs under launch tables built
    with its knobs (as ``build_plan`` builds them); the sweep runs
    ``passes`` times and ranks each candidate's least time.  A candidate
    that raises is recorded as None and not run again; if every candidate
    fails, or the sweep is interrupted, the entry in place before the call
    is restored.  :data:`ABLATE`
    still overrides.  ``save_path`` writes the whole table
    (:func:`save_tuned`).  Returns ``(best_knobs, {repr(knobs): seconds or
    None})``."""
    if not isinstance(rf, torch.Tensor) or not rf.is_cuda:
        raise ValueError("autotune_das times the CUDA kernel: rf must be a "
                         "CUDA tensor (the plain twin has no knobs)")
    if candidates is None:
        candidates = _default_candidates(st)
    key = _tune_key(st)
    for knobs in candidates:
        check_knobs(key, knobs)
    _load_shipped_tuned()
    prior = TUNED.get(key)
    results: dict = {}
    best = None
    try:
        for _ in range(max(1, passes)):
            for knobs in candidates:
                if repr(knobs) in results and results[repr(knobs)] is None:
                    continue
                TUNED[key] = dict(knobs)
                try:
                    d = dict(dyn, launch=launch_tables(st, dyn))
                    # the events on the card that holds rf
                    with device_utils.on_device(rf):
                        dt = device_utils.event_seconds(
                            lambda: das_cuda(rf, d, st), iters, warmup)
                except (RuntimeError, ValueError) as e:   # it may not launch
                    results[repr(knobs)] = None
                    if verbose:
                        print(f"[autotune] {knobs}: FAIL "
                              f"{type(e).__name__}: {str(e)[:200]}",
                              flush=True)
                    continue
                prev = results.get(repr(knobs))
                results[repr(knobs)] = dt if prev is None else min(prev, dt)
                if verbose:
                    print(f"[autotune] {knobs}: {dt * 1e3:.3f} ms",
                          flush=True)
        timed = [(t, i) for i, knobs in enumerate(candidates)
                 if (t := results.get(repr(knobs))) is not None]
        if timed:
            best = dict(candidates[min(timed)[1]])
    finally:
        # the candidate last run never stays installed unless it was chosen
        if best is not None:
            TUNED[key] = best
        elif prior is None:
            TUNED.pop(key, None)
        else:
            TUNED[key] = prior
    if best is None:
        best = {}
    if save_path is not None:
        save_tuned(save_path)
    return best, results
