"""Compute-plan builder: the torch counterpart of
``ogl_beamforming_tpu.pipeline.plan``.

A plan is the pipeline spec walked into static stage descriptors plus the
dynamic parameters as tensors on the plan's device.  PyTorch runs eagerly,
so there is no compile step and no program cache: :func:`compose_stages`
runs the stages in order, each one dispatching to its CUDA kernel or its
plain twin by the device of the data.

Ported stages: Decode (Hadamard and Walsh) and DAS (the FORCES family).
Demodulate, Filter and Hilbert raise ``NotImplementedError`` when the plan
is built (queued in ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ogl_beamforming_tpu.params.enums import (BeamformerError, DataKind,
                                              DecodeMode, ErrorKind,
                                              ShaderKind)
from ogl_beamforming_tpu.params.types import Parameters
from ogl_beamforming_tpu.pipeline.spec import PipelineSpec
from ogl_beamforming_tpu.utils.filters import Filter
from ogl_beamforming_tpu.utils.hadamard import hadamard, walsh
from ogl_beamforming_tpu.utils.transforms import das_output_dimension

from ..ops import das as das_ops
from ..ops.coherency import coherency_weighting
from ..ops.decode import decode_hadamard
from ..ops.golden import DasParams
from ..utils.device import resolve_device


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


@dataclass
class CompiledPlan:
    """A built plan: call it with canonical (C, A, S_wire) RF on its
    device."""

    descriptor: PlanDescriptor
    dyn: dict                        # dynamic parameters, tensors on device

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


def build_plan(parameters: Parameters, pipeline: PipelineSpec,
               filters: dict[int, Filter], sparse_elements=None,
               focal_vectors=None, transmit_receive_orientations=None,
               device="cpu") -> CompiledPlan:
    """Build the plan for a parameter block's current state, with its
    dynamic parameters on ``device``."""
    dev = resolve_device(device)
    stage_descs, sample_count, fs, time_offset, iq = _plan_stages(
        parameters, pipeline, filters)
    for sd in stage_descs:
        if sd.kind in (ShaderKind.Demodulate, ShaderKind.Filter,
                       ShaderKind.Hilbert):
            raise NotImplementedError(
                f"the {sd.kind.name} stage is not ported yet; see ROADMAP.md")

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
        das_static = das_ops.make_static(dp, iq=iq)
        das_ops.check_supported(das_static)
        das_dyn = das_ops.make_dynamic(dp, dev)
        stage_descs.append(StageDesc(kind=ShaderKind.DAS, das=das_static))

    desc = PlanDescriptor(
        stages=tuple(stage_descs),
        data_kind=pipeline.data_kind,
        channel_count=parameters.channel_count,
        acquisition_count=parameters.acquisition_count,
        sample_count=parameters.sample_count,
        iq_pipeline=iq,
        coherency_weighting=bool(parameters.coherency_weighting) and has_das,
    )

    dyn: dict = {"das": das_dyn}
    for i, sd in enumerate(stage_descs):
        if sd.kind == ShaderKind.Decode:
            dyn[f"hadamard{i}"] = torch.as_tensor(
                _decode_matrix(parameters), dtype=torch.float32, device=dev)
    dyn["sampling_frequency"] = torch.tensor(
        np.float32(parameters.sampling_frequency), device=dev)
    dyn["demodulation_frequency"] = torch.tensor(
        np.float32(parameters.demodulation_frequency), device=dev)

    return CompiledPlan(descriptor=desc, dyn=dyn)


def compose_stages(desc: PlanDescriptor, rf: torch.Tensor, dyn: dict,
                   mark=None):
    """Run the stages of ``desc`` on ``rf`` (canonical (C, A, S_wire) raw
    data on the plan's device).  ``mark``, when given, is called after each
    stage (the executor's per-stage clock).  Returns the (nx, ny, nz) frame,
    with coherency weighting already applied as part of the DAS stage, or
    the last stage's output for a pipeline without DAS."""
    x = rf
    if desc.data_kind.is_complex:
        # Interleaved scalar pairs -> complex64 (I, Q adjacent samples) for
        # all complex wire kinds (reference: shaders/reshape.glsl:30-82).
        x = x.to(torch.float32)
        x = torch.complex(x[..., 0::2], x[..., 1::2])
    out = None
    for i, sd in enumerate(desc.stages):
        if sd.kind == ShaderKind.Decode:
            x = decode_hadamard(x, dyn[f"hadamard{i}"])
        elif sd.kind == ShaderKind.DAS:
            rf_das = x if x.is_complex() else x.to(torch.float32)
            out = das_ops.das(rf_das.contiguous(), dyn["das"], sd.das)
            if desc.coherency_weighting:
                out = coherency_weighting(*out)
        else:
            raise NotImplementedError(
                f"the {sd.kind.name} stage is not ported yet; see ROADMAP.md")
        if mark is not None:
            mark()
    return x if out is None else out
