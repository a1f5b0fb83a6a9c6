"""Compute-plan builder: the torch counterpart of
``ogl_beamforming_tpu.pipeline.plan``.

A plan is the pipeline spec walked into static stage descriptors plus the
dynamic parameters as tensors on the plan's device.  PyTorch runs eagerly,
so there is no compile step and no program cache: :func:`compose_stages`
runs the stages in order, each one dispatching to its CUDA kernel or its
plain twin by the device of the data (the DAS stage by the plan's
``das_backend``, :func:`resolve_das_backend`).  :func:`compiled_stage_fns`
gives the stages one at a time, as the JAX package's profile mode runs
them; they are the one thing kept per descriptor, and
:func:`clear_plan_cache` drops them.

Ported stages: Demodulate, Filter, Hilbert, Decode (Hadamard and Walsh)
and DAS (every family).  A plan built with ``frame_batch=B > 1`` takes B
frames (B, C, A, S_wire) per call and returns (B, nx, ny, nz) volumes.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import das as das_ops
from ..ops.coherency import coherency_weighting
from ..ops.das_cuda import launch_tables
from ..ops.decode import decode_hadamard
from ..ops.filtering import (demod_omega, demod_phasor, demodulate,
                             fir_filter, hilbert)
from ..ops.golden import DasParams
from ..params.enums import (BeamformerError, DataKind, DecodeMode, ErrorKind,
                            ShaderKind)
from ..params.types import Parameters
from ..utils.device import resolve_device
from ..utils.filters import Filter
from ..utils.hadamard import hadamard, walsh
from ..utils.transforms import das_output_dimension
from .spec import PipelineSpec


@dataclass(frozen=True)
class StageDesc:
    """Static descriptor of one pipeline stage."""

    kind: ShaderKind
    # Filter/Demodulate:
    filter_length: int = 0
    filter_complex: bool = False
    decimation_rate: int = 1
    # DAS:
    das: das_ops.DasStatic | None = None


@dataclass(frozen=True)
class PlanDescriptor:
    """Everything that shapes the computation (hashable)."""

    stages: tuple[StageDesc, ...]
    data_kind: DataKind
    channel_count: int
    acquisition_count: int
    sample_count: int
    iq_pipeline: bool
    coherency_weighting: bool
    frame_batch: int = 1


@dataclass
class CompiledPlan:
    """A built plan: call it with canonical (C, A, S_wire) RF on its
    device, or (B, C, A, S_wire) for a plan of ``frame_batch = B > 1``.
    ``fn(rf, dyn)`` is the plan's function of its dynamic parameters, as
    the JAX package's jitted one (here :func:`compose_stages` on the
    plan's descriptor); the other fields are the planner's facts, as the
    JAX package keeps them."""

    descriptor: PlanDescriptor
    dyn: dict                        # dynamic parameters, tensors on device
    output_points: tuple[int, int, int]
    iq: bool
    time_offset: float
    das_sample_count: int
    das_sampling_frequency: float

    @property
    def fn(self):
        return functools.partial(compose_stages, self.descriptor)

    def __call__(self, rf, mark=None):
        return compose_stages(self.descriptor, rf, self.dyn, mark)


def _plan_stages(parameters: Parameters, pipeline: PipelineSpec,
                 filters: dict[int, Filter]):
    """Walk the user pipeline mirroring the reference planner's prologue
    (beamformer_core.c:412-467): demodulation halves sample count and fs,
    filter delays accumulate into the DAS time offset, IQ-ness decides the
    DAS data kind.  (A copy of the JAX package's ``_plan_stages``, which
    lives in a module that imports jax.)"""
    stage_descs: list[StageDesc] = []
    sample_count = parameters.sample_count
    fs = float(parameters.sampling_frequency)
    time_offset = float(parameters.time_offset)
    decimation_rate = max(int(parameters.decimation_rate), 1)
    iq = pipeline.data_kind.is_complex

    run_hilbert = any(s.kind == ShaderKind.Hilbert for s in pipeline.stages)
    run_demodulate = any(s.kind == ShaderKind.Demodulate
                         for s in pipeline.stages)
    if run_demodulate:
        run_hilbert = False          # beamformer_core.c:426

    def get_filter(slot):
        if slot not in filters:
            raise BeamformerError(ErrorKind.InvalidFilterKind,
                                  f"filter slot {slot} not created")
        return filters[slot]

    for stage in pipeline.stages:
        kind = stage.kind
        if kind == ShaderKind.Decode:
            if parameters.decode_mode == DecodeMode.NoDecode:
                continue             # beamformer_core.c:487-489
            stage_descs.append(StageDesc(kind=ShaderKind.Decode))
        elif kind == ShaderKind.Demodulate:
            f = get_filter(stage.parameter)
            time_offset += f.time_delay
            stage_descs.append(StageDesc(
                kind=kind, filter_length=f.length, filter_complex=f.complex,
                decimation_rate=decimation_rate))
            sample_count = sample_count // 2 // decimation_rate
            fs = fs / 2.0 / decimation_rate
            iq = True
        elif kind == ShaderKind.Filter:
            f = get_filter(stage.parameter)
            time_offset += f.time_delay
            stage_descs.append(StageDesc(
                kind=kind, filter_length=f.length, filter_complex=f.complex))
        elif kind == ShaderKind.Hilbert:
            if not run_hilbert:
                continue
            stage_descs.append(StageDesc(kind=kind))
            iq = True
        elif kind == ShaderKind.DAS:
            pass                     # appended below with full static config
        elif kind in (ShaderKind.Sum, ShaderKind.MinMax):
            continue                 # dormant in reference planner (:491-496)
        else:
            continue
    return stage_descs, sample_count, fs, time_offset, iq


def _decode_matrix(parameters: Parameters) -> np.ndarray:
    try:
        if parameters.decode_mode == DecodeMode.Walsh:
            return walsh(parameters.acquisition_count)
        return hadamard(parameters.acquisition_count)
    except ValueError as e:
        raise BeamformerError(
            ErrorKind.InvalidComputeStage,
            f"Hadamard decode needs a supported order "
            f"(2^k, 12*2^k, 20*2^k; Walsh: 2^k only): {e}")


DAS_BACKENDS = {"auto": None, "cuda": "cuda", "pallas": "cuda",
                "torch": "torch", "xla": "torch", "pallas_interpret": "torch"}
"""The ``das_backend`` names :func:`resolve_das_backend` takes (the JAX
package's and the port's), and the DAS each runs: ``None`` for the
device's own."""


def resolve_das_backend(backend: str = "auto", device="cuda") -> str:
    """The ``DasStatic.backend`` of a plan on ``device`` built with
    ``das_backend=backend``: ``"auto"`` the CUDA kernel on a GPU and the
    plain twin on the CPU; ``"cuda"`` or the JAX package's ``"pallas"`` the
    kernel, which a CPU plan refuses (``ValueError``); ``"torch"`` or the
    JAX package's ``"xla"`` and ``"pallas_interpret"`` the plain twin, on
    whatever device the plan is on."""
    if backend not in DAS_BACKENDS:
        raise ValueError(f"DAS backend {backend!r} is not one of "
                         f"{sorted(DAS_BACKENDS)}")
    dev = torch.device(device)
    out = DAS_BACKENDS[backend] or ("cuda" if dev.type == "cuda"
                                    else "torch")
    if out == "cuda" and dev.type != "cuda":
        raise ValueError(f"DAS backend {backend!r} runs the CUDA kernel; "
                         f"the plan is on {dev}")
    return out


def build_plan(parameters: Parameters, pipeline: PipelineSpec,
               filters: dict[int, Filter], channel_mapping=None,
               sparse_elements=None, focal_vectors=None,
               transmit_receive_orientations=None, voxel_block: int = 65536,
               das_backend: str = "auto", device="cuda",
               frame_batch: int = 1) -> CompiledPlan:
    """Build the plan for a parameter block's current state, with its
    dynamic parameters on ``device`` (a GPU unless the caller asks for the
    CPU; ``RuntimeError`` when no GPU is available).  ``frame_batch=B > 1``
    builds a batched plan: B frames per call, each DAS launch taking up to
    four of them (``ops/das_cuda.py``).  ``das_backend`` chooses the DAS
    (:func:`resolve_das_backend`); the plain twin computes ``voxel_block``
    voxels at once.  ``channel_mapping`` is taken and not used, as in the
    JAX package: the executor maps channels when it prepares a frame.  On
    the GPU the DAS launch tables are built here under the knobs installed
    for the plan's configuration (``das_cuda.TUNED``): a ``load_tuned`` or
    ``autotune_das`` after it takes effect at the next ``build_plan``, as a
    JAX plan traced before a table changed keeps its knobs until it is
    traced again."""
    dev = resolve_device(device)
    # "auto" stays "auto", the DAS of the data's device (the plan's), so a
    # plan's DAS follows its tensors as every other stage does
    backend = ("auto" if das_backend == "auto"
               else resolve_das_backend(das_backend, dev))
    stage_descs, sample_count, fs, time_offset, iq = _plan_stages(
        parameters, pipeline, filters)

    has_das = any(s.kind == ShaderKind.DAS for s in pipeline.stages)
    output_points = tuple(
        int(v) for v in das_output_dimension(parameters.output_points[:3]))

    das_dyn = {}
    if has_das:
        # FORCES-family voxel transforms get the XDC transform premultiplied
        # (beamformer_core.c:757-763); the kernel then works in XDC space.
        vt = np.asarray(parameters.das_voxel_transform, np.float32)
        kind = parameters.acquisition_kind
        if kind.name in ("FORCES", "UFORCES"):
            vt = np.asarray(parameters.xdc_transform, np.float32) @ vt

        readi = int(parameters.readi_group_count)
        dp = DasParams(
            acquisition_kind=kind,
            acquisition_count=parameters.acquisition_count,
            channel_count=parameters.channel_count,
            sample_count=sample_count,
            sampling_frequency=fs,
            demodulation_frequency=parameters.demodulation_frequency,
            speed_of_sound=parameters.speed_of_sound,
            time_offset=time_offset,
            interpolation_mode=parameters.interpolation_mode,
            f_number=parameters.f_number,
            voxel_transform=vt,
            xdc_transform=np.asarray(parameters.xdc_transform, np.float32),
            xdc_element_pitch=np.asarray(parameters.xdc_element_pitch,
                                         np.float32),
            output_points=output_points,
            single_orientation=bool(parameters.single_orientation),
            transmit_receive_orientation=int(
                parameters.transmit_receive_orientation),
            single_focus=bool(parameters.single_focus),
            transmit_angle=float(parameters.focal_vector[0]),
            focus_depth=float(parameters.focal_vector[1]),
            focal_vectors=focal_vectors,
            transmit_receive_orientations=transmit_receive_orientations,
            sparse=kind.sparse,
            sparse_elements=sparse_elements,
            readi_group_count=readi,
            readi_group=int(parameters.readi_group),
            das_hadamard=(np.asarray(
                hadamard(readi), np.float32).T if readi > 1 else None),
            coherency_weighting=bool(parameters.coherency_weighting),
        )
        das_static = dataclasses.replace(
            das_ops.make_static(dp, iq=iq, voxel_block=voxel_block),
            backend=backend, frame_batch=int(frame_batch))
        das_dyn = das_ops.make_dynamic(dp, dev)
        if dev.type == "cuda" and backend != "torch" \
                and das_static.family != "none":
            # the kernel's scalar vector, tables and launch knobs depend
            # only on the plan
            das_dyn["launch"] = launch_tables(das_static, das_dyn)
        stage_descs.append(StageDesc(kind=ShaderKind.DAS, das=das_static))

    desc = PlanDescriptor(
        stages=tuple(stage_descs),
        data_kind=pipeline.data_kind,
        channel_count=parameters.channel_count,
        acquisition_count=parameters.acquisition_count,
        sample_count=parameters.sample_count,
        iq_pipeline=iq,
        coherency_weighting=bool(parameters.coherency_weighting) and has_das,
        frame_batch=int(frame_batch),
    )

    dyn: dict = {"das": das_dyn}
    fs_t = torch.tensor(np.float32(parameters.sampling_frequency), device=dev)
    fd_t = torch.tensor(np.float32(parameters.demodulation_frequency),
                        device=dev)
    samples = parameters.sample_count      # along a row entering stage i
    for i, sd in enumerate(stage_descs):
        if sd.kind in (ShaderKind.Filter, ShaderKind.Demodulate):
            f = filters[_stage_parameter(pipeline, sd.kind, i, stage_descs)]
            dyn[f"taps{i}"] = torch.as_tensor(f.taps, device=dev)
        elif sd.kind == ShaderKind.Decode:
            dyn[f"hadamard{i}"] = torch.as_tensor(
                _decode_matrix(parameters), dtype=torch.float32, device=dev)
        if sd.kind == ShaderKind.Demodulate:
            # the rotation's cos and sin, once per plan, beside the taps:
            # omega is that of the plan's frequencies, which the stage
            # passes (compose_stages)
            dyn[f"phasor{i}"] = demod_phasor(
                demod_omega(fd_t, fs_t, dev), samples // 2)
            samples = samples // 2 // sd.decimation_rate
    dyn["sampling_frequency"] = fs_t
    dyn["demodulation_frequency"] = fd_t

    return CompiledPlan(descriptor=desc, dyn=dyn,
                        output_points=output_points, iq=iq,
                        time_offset=time_offset,
                        das_sample_count=sample_count,
                        das_sampling_frequency=fs)


def _stage_parameter(pipeline: PipelineSpec, kind: ShaderKind, index,
                     stage_descs) -> int:
    """The filter slot of the ``index``-th planned stage, a stage of
    ``kind``: planned stages keep the user's order, so it is the slot of
    the n-th stage of that kind in the pipeline."""
    occurrence = sum(1 for sd in stage_descs[:index] if sd.kind == kind)
    seen = 0
    for s in pipeline.stages:
        if s.kind == kind:
            if seen == occurrence:
                return s.parameter
            seen += 1
    raise KeyError(kind)


def _wire_samples(desc: PlanDescriptor, rf: torch.Tensor) -> torch.Tensor:
    """Interleaved scalar pairs -> complex64 (I, Q adjacent samples) for all
    complex wire kinds (reference: shaders/reshape.glsl:30-82); real wire
    data as it is."""
    if not desc.data_kind.is_complex:
        return rf
    x = rf.to(torch.float32)
    return torch.complex(x[..., 0::2], x[..., 1::2])


def stage_steps(desc: PlanDescriptor, rf: torch.Tensor, dyn: dict,
                skip_coherency_normalize: bool = False,
                stage_key_offset: int = 0):
    """The stages of ``desc`` on ``rf`` one at a time: a generator that
    yields once after each stage what the frame is then (a batch as
    (B, ...)), and after the DAS stage the volume, or the ``(coherent,
    incoherent)`` pair with coherency weighting when
    ``skip_coherency_normalize`` defers the weighting to the caller (the
    sharded plans of ``parallel/sharding.py`` weight once, after the sum
    over channel shards).  The value yielded last is the plan's result.
    Stage ``i`` reads its entries of ``dyn`` (``hadamard``, ``taps``,
    ``phasor``) under ``i + stage_key_offset``: a descriptor of some of a
    plan's stages (:func:`compiled_stage_fns`) reads the whole plan's."""
    x = _wire_samples(desc, rf)
    batch = desc.frame_batch
    if batch > 1:
        # Decode mixes acquisitions of one channel and Demodulate, Filter
        # and Hilbert act along the samples of one (channel, acquisition)
        # row, so a batch runs through the pre-DAS kernels as B * C
        # channels of one frame: no batched kernel is needed before DAS.
        x = x.reshape((batch * x.shape[1],) + tuple(x.shape[2:]))
    for i, sd in enumerate(desc.stages, start=stage_key_offset):
        if sd.kind == ShaderKind.Decode:
            x = decode_hadamard(x, dyn[f"hadamard{i}"])
        elif sd.kind == ShaderKind.Demodulate:
            x = demodulate(x, dyn[f"taps{i}"], dyn["demodulation_frequency"],
                           dyn["sampling_frequency"], sd.decimation_rate,
                           sd.filter_complex, dyn[f"phasor{i}"])
        elif sd.kind == ShaderKind.Filter:
            x = fir_filter(x, dyn[f"taps{i}"], 1)
        elif sd.kind == ShaderKind.Hilbert:
            x = hilbert(x)
        elif sd.kind == ShaderKind.DAS:
            rf_das = x if x.is_complex() else x.to(torch.float32)
            if batch > 1:
                rf_das = rf_das.reshape((batch, -1) + tuple(x.shape[1:]))
            out = das_ops.das(rf_das.contiguous(), dyn["das"], sd.das)
            if desc.coherency_weighting and not skip_coherency_normalize:
                out = coherency_weighting(*out)
            yield out
            continue
        yield x.reshape((batch, -1) + tuple(x.shape[1:])) if batch > 1 else x


def compose_stages(desc: PlanDescriptor, rf: torch.Tensor, dyn: dict,
                   mark=None, skip_coherency_normalize: bool = False,
                   stage_key_offset: int = 0):
    """Run the stages of ``desc`` on ``rf`` (canonical (C, A, S_wire) raw
    data on the plan's device, or (B, C, A, S_wire) for a batch of
    ``desc.frame_batch = B > 1``).  ``mark``, when given, is called after
    each stage (the executor's per-stage clock).  Returns the (nx, ny, nz)
    frame (or (B, nx, ny, nz) frames), with coherency weighting already
    applied as part of the DAS stage unless ``skip_coherency_normalize``
    (then the ``(coherent, incoherent)`` pair), or the last stage's output
    for a pipeline without DAS.  ``stage_key_offset``: as in
    :func:`stage_steps`."""
    out = None
    for out in stage_steps(desc, rf, dyn, skip_coherency_normalize,
                           stage_key_offset):
        if mark is not None:
            mark()
    return out if desc.stages else _wire_samples(desc, rf)


@functools.lru_cache(maxsize=32)
def compiled_stage_fns(desc: PlanDescriptor) -> tuple:
    """One callable ``fn(x, dyn)`` per stage of ``desc``, as the JAX
    package's profile mode runs its stages: stage ``i`` takes what stage
    ``i - 1`` returned (the first the canonical raw frame) and the whole
    plan's ``dyn``, and the DAS stage returns the frame, coherency-weighted
    where the plan weights.  Chained, they compute :func:`compose_stages`
    operation for operation.  Kept per descriptor, up to 32 of them, until
    :func:`clear_plan_cache`."""
    def stage(i: int):
        # the raw frame's wire pairing belongs to the first stage only
        sub = dataclasses.replace(
            desc, stages=desc.stages[i:i + 1],
            data_kind=desc.data_kind if i == 0 else DataKind.Float32)
        return lambda x, dyn: compose_stages(sub, x, dyn,
                                             stage_key_offset=i)
    return tuple(stage(i) for i in range(len(desc.stages)))


def clear_plan_cache() -> None:
    """Drop what the planner keeps per descriptor (the JAX package's
    compiled-plan cache): :func:`compiled_stage_fns`' stage callables."""
    compiled_stage_fns.cache_clear()
