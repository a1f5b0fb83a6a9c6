"""ogl_beamforming_tpu_torch — the PyTorch/CUDA port of ogl_beamforming_tpu.

The same beamforming pipeline as the JAX package, written in PyTorch for an
NVIDIA Hopper GPU: plain torch for planning and glue, and hand-written CUDA
kernels (``csrc/``, built at first use by ``kernels/build.py``) for the two
stages of the main path, Hadamard decode and FORCES delay-and-sum.  Every
kernel has a plain-torch twin beside it; a CPU tensor takes the twin, a CUDA
tensor takes the kernel or raises.

The JAX-free modules of ``ogl_beamforming_tpu`` (parameter schema, host DSP,
the NumPy golden oracle, presets, host RF preparation) are reused by import.
This package never imports jax.

Layout:
  utils/     device helpers (resolve_device, sync, to_host)
  kernels/   nvcc build of csrc/*.cu into a ctypes-loaded library
  csrc/      CUDA C++ kernels for sm_90a
  ops/       decode, DAS (plain twins + kernel dispatch), coherency
  pipeline/  plan builder and the Beamformer executor
  convert.py JAX plan parameters -> this package's tensors
"""

import torch

from ogl_beamforming_tpu.params.constants import API_VERSION  # noqa: F401
from ogl_beamforming_tpu.params.enums import (  # noqa: F401
    AcquisitionKind, BeamformerError, DataKind, DecodeMode, ErrorKind,
    FilterKind, InterpolationMode, RCAOrientation, ShaderKind)
from ogl_beamforming_tpu.params.types import (  # noqa: F401
    FilterParameters, Parameters, SimpleParameters)

__version__ = "0.1.0"

# Full float32 everywhere: the plain decode twin is a matmul, and under TF32
# (10-bit mantissa) it would no longer be exact for int16 RF on the GPU.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
