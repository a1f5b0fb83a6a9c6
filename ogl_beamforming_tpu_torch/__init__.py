"""ogl_beamforming_tpu_torch — the PyTorch/CUDA port of ogl_beamforming_tpu.

The same beamforming pipeline as the JAX package, written in PyTorch for an
NVIDIA Hopper GPU: plain torch for planning and glue, and hand-written CUDA
kernels (``csrc/``, built at first use by ``kernels/build.py``) for the
stages of the ported paths: demodulation and FIR filtering, Hadamard decode,
and FORCES- and RCA-family delay-and-sum.  Every kernel has a plain-torch
twin beside it; a CPU tensor takes the twin, a CUDA tensor takes the kernel
or raises.

The package imports nothing of ``ogl_beamforming_tpu`` and never imports
jax.  The jax-free modules it needs are its own copies, at the same relative
paths and kept equal to the originals by ``tests/test_torch_pipeline.py``:
``params/{constants,enums,types}``, ``utils/{hadamard,transforms,filters}``,
``pipeline/{spec,stats}``, ``runtime/upload``, ``models/presets`` and the
NumPy golden oracle ``ops/golden``.

Layout:
  params/    parameter schema (copies)
  utils/     device helpers; host DSP (copies)
  kernels/   nvcc build of csrc/*.cu into a ctypes-loaded library
  csrc/      CUDA C++ kernels for sm_90a
  ops/       filtering, decode, DAS (plain twins + kernel dispatch),
             coherency; golden (copy)
  pipeline/  plan builder and the Beamformer executor
  runtime/   RF preparation on the host (copy) and on the device; the
             streaming session
  models/    presets (copy)
  convert.py the JAX package's parameters and plan parameters -> this
             package's
"""

import torch

from .params.constants import API_VERSION  # noqa: F401
from .params.enums import (  # noqa: F401
    AcquisitionKind, BeamformerError, DataKind, DecodeMode, ErrorKind,
    FilterKind, InterpolationMode, RCAOrientation, ShaderKind)
from .params.types import (  # noqa: F401
    FilterParameters, KaiserFilterParameters, MatchedChirpFilterParameters,
    Parameters, SimpleParameters)

__version__ = "0.1.0"

# Full float32 everywhere: the plain decode twin is a matmul, and under TF32
# (10-bit mantissa) it would no longer be exact for int16 RF on the GPU.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
