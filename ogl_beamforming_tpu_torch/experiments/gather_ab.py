"""The K5/K6 gather kernels of other ``micro_gather.cu`` sources timed
beside this one's, on Hopper: an older commit's source, and ablations of
this one, each made by replacing a line of it.

Each source is compiled alone (the library's nvcc flags) into a library of
its own under ``_build/`` and launched through its ``micro_gather`` entry
point: K5 ``mod`` and K6 ``hermite_pair``, in shared memory and through
``__ldg``, at STEPS = 512 and REPS 8, 64 and 128, the sources in the order
given and then reversed (A, B, B, A), each launch timed by the kernel time
of a profiler trace (``traced_ms``).  Every source's tile is first held
against the plain version (K5 bit-equal, K6 NRMSE 1e-6).

  store_every     every unit stores its results (512 stores onto each row
                  of the output), not step 0's alone
  bundle_by_step  K6's cubic-tap bundle written as K7's (``step``), not
                  ``hermite_reps``' paired FMAs

Run on the card, from the repository root:

    python -m ogl_beamforming_tpu_torch.experiments.gather_ab \\
        [--source parent=OLD/micro_gather.cu ...] [--ablations]
"""

from __future__ import annotations

import argparse
import json

import torch

from . import (LANE, ROWS, ab_sources, card, check_gather_args,
               compile_source, require_gpu, traced_ms)
from . import gather_micro, gather_micro2

ABLATIONS = {
    "store_every": [("bool keep = u < kUnitsPerStep;", "bool keep = true;")],
    "bundle_by_step": [("if constexpr (hermite(V)) {", "if constexpr (false) {")],
}
"""{name: [(text of the source, its replacement)]}."""
REPS = (8, 64, 128)
STEPS = 512


def sources(others: list[str], ablations: bool) -> dict:
    """{label: source text}: the ``LABEL=PATH`` sources of ``others``, this
    tree's ``micro_gather.cu`` ("change") and, with ``ablations``, the
    ablations of it."""
    return ab_sources("micro_gather.cu", others,
                      ABLATIONS if ablations else {})


def cases(dev) -> dict:
    """{(kernel, variant): (variant id, src, src2, idx, w, exact)} at the
    TPU files' inputs."""
    x5, x6 = gather_micro.make_inputs(dev), gather_micro2.make_inputs(dev)
    src, src2 = x6["hermite_pair"]
    return {("K5", "mod"): (gather_micro.VARIANT_IDS["mod"], x5["src"],
                            x5["src"], x5["idx"], x5["src"], True),
            ("K6", "hermite_pair"): (gather_micro2.VARIANT_IDS["hermite_pair"],
                                     src, src2, x6["idx"], x6["w"], False)}


def measure(libs: dict, dev) -> dict:
    """{label: {"K5 mod shared REPS 64": [trace ms per pass], ...}}: the
    labels in order and then reversed, each source's tiles checked first."""
    runs = {label: {} for label in libs}
    checked = set()
    for label in list(libs) + list(reversed(libs)):
        lib = libs[label]
        for (kernel, variant), (vid, a, b, idx, w, exact) in cases(dev).items():
            check_gather_args(a, b, idx, w, kernel == "K6")
            for smem in (True, False):
                for reps in REPS:
                    out = torch.empty((ROWS, LANE), dtype=torch.float32,
                                      device=dev)

                    def fn(lib=lib, vid=vid, a=a, b=b, idx=idx, w=w,
                           out=out, reps=reps, smem=smem):
                        code = lib.micro_gather(
                            vid, int(smem), a.data_ptr(), b.data_ptr(),
                            idx.data_ptr(), w.data_ptr(), out.data_ptr(),
                            reps, STEPS,
                            torch.cuda.current_stream(dev).cuda_stream)
                        if code:
                            raise RuntimeError(f"{label}: cudaError {code}")
                        return out

                    key = f"{kernel} {variant} {'shared' if smem else 'global'}"
                    if (label, key, reps) not in checked:
                        got = fn()
                        ref = (gather_micro.kernel_ref(variant, a, idx, reps)
                               if kernel == "K5" else gather_micro2.kernel_ref(
                                   variant, a, b, idx, w, reps))
                        torch.cuda.synchronize()
                        err = float(((got - ref).pow(2).mean().sqrt()
                                     / ref.pow(2).mean().sqrt()))
                        if (exact and not torch.equal(got, ref)) or err > 1e-6:
                            raise RuntimeError(f"{label} {key} REPS {reps}: "
                                               f"NRMSE {err:.3e}")
                        checked.add((label, key, reps))
                    runs[label].setdefault(f"{key} REPS {reps}", []).append(
                        traced_ms(fn, kernel="gather_"))
    return runs


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="LABEL=PATH", help="another micro_gather.cu to "
                    "time beside this tree's (an older commit's), timed first")
    ap.add_argument("--ablations", action="store_true",
                    help="also the ablations of this tree's source")
    args = ap.parse_args(argv)
    dev = require_gpu(device)
    print(json.dumps(card()), flush=True)
    libs = {label: compile_source(text, label, "micro_gather")
            for label, text in sources(args.source, args.ablations).items()}
    results = measure(libs, dev)
    for label, by_case in results.items():
        for case, ms in by_case.items():
            print(json.dumps({"source": label, "case": case,
                              "trace_ms": ms}), flush=True)
    print(json.dumps(card()), flush=True)
    return results


if __name__ == "__main__":
    main()
