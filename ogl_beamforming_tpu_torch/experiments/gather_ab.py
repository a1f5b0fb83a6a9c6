"""The gather kernels of other ``micro_gather.cu`` sources timed beside
this one's, on Hopper: an older commit's source, and ablations of this one,
each made by replacing a line of it.

Each source is compiled alone (the library's nvcc flags; the sources side
by side) into a library of its own under ``_build/`` and launched through
its ``micro_gather`` and ``micro_gather_hermite`` entry points, the sources
in the order given and then reversed (A, B, B, A), each launch timed by
the kernel time of a profiler trace (``traced_ms``): K5 ``mod`` and K6
``hermite_pair`` in shared memory and through ``__ldg`` at STEPS = 512 and
REPS 8, 64 and 128; K7 ``hermite_pair`` at its module's STEPS and REPS 32
and 224, the K9 bundle at its STEPS and UNITS 4 and 28, and the K8 bundle
at its STEPS and UNITS, in shared memory.  Every source's tile is first
held against the plain version (K5 bit-equal, the rest NRMSE 1e-6).

  store_every     every unit stores its results (512 stores onto each row
                  of the output), not step 0's alone
  bundle_by_step  K6's cubic-tap bundle written as ``step``, not
                  ``hermite_reps``' paired FMAs
  lane_identity   the walk kernel's lanes in element order (the parent's
                  lane order), not dealt by bank group
  convert_i2f     every hi half through I2F, the slope plane's too (its
                  weight halved), not the value plane's alone
  convert_magic   every hi half by the exponent trick, the value plane's
                  too

Run on the card, from the repository root:

    python -m ogl_beamforming_tpu_torch.experiments.gather_ab \\
        [--source parent=OLD/micro_gather.cu ...] [--ablations]
"""

from __future__ import annotations

import argparse
import json
from concurrent.futures import ThreadPoolExecutor

import torch

from ..utils.device import launch_stream, on_device
from . import (LANE, ROWS, ab_sources, card, check_gather_args,
               compile_source, gather_hermite_ref, require_gpu, traced_ms)
from . import gather_micro, gather_micro2, gather_micro3, onehot_micro, \
    onehot_micro2

ABLATIONS = {
    "store_every": [("bool keep = u < kUnitsPerStep;", "bool keep = true;"),
                    ("const bool keep = u < kWalkUnitsPerStep ||",
                     "const bool keep = true ||")],
    "bundle_by_step": [("if constexpr (hermite(V)) {", "if constexpr (false) {")],
    "lane_identity": [("constexpr bool kSpreadLanes = true;",
                       "constexpr bool kSpreadLanes = false;")],
    "convert_i2f": [("constexpr int kHiI2F = 0x0F;", "constexpr int kHiI2F = 0xFF;")],
    "convert_magic": [("constexpr int kHiI2F = 0x0F;", "constexpr int kHiI2F = 0x00;")],
}
"""{name: [(text of the source, its replacement)]}."""
REPS = (8, 64, 128)
STEPS = 512
K7_REPS = (32, 224)
K9_UNITS = (4, 28)


def sources(others: list[str], ablations: bool) -> dict:
    """{label: source text}: the ``LABEL=PATH`` sources of ``others``, this
    tree's ``micro_gather.cu`` ("change") and, with ``ablations``, the
    ablations of it."""
    return ab_sources("micro_gather.cu", others,
                      ABLATIONS if ablations else {})


def cases(dev) -> list:
    """[(name, memory spaces, counts, steps, launch, plain, exact)]:
    ``launch(lib, out, count, smem)`` launches the case through ``lib``'s
    entry point, ``plain(count)`` is its plain version's tile; at the TPU
    files' inputs."""
    x5, x6 = gather_micro.make_inputs(dev), gather_micro2.make_inputs(dev)
    x7, xb = gather_micro3.make_inputs(dev), onehot_micro.make_inputs(dev)
    s6, s6b = x6["hermite_pair"]
    s7, s7b = gather_micro3.sources("hermite_pair", x7)
    g = (xb["src"], xb["src2"], xb["idx"], xb["w"])

    def gather(vid, a, b, idx, w, steps):
        check_gather_args(a, b, idx, w, vid != gather_micro.VARIANT_IDS["mod"])
        return lambda lib, out, reps, smem: lib.micro_gather(
            vid, int(smem), a.data_ptr(), b.data_ptr(), idx.data_ptr(),
            w.data_ptr(), out.data_ptr(), reps, steps, launch_stream(out))

    def bundle(k8, steps):
        check_gather_args(*g, True)
        return lambda lib, out, units, smem: lib.micro_gather_hermite(
            int(k8), int(smem), *(t.data_ptr() for t in g), out.data_ptr(),
            units, steps, launch_stream(out))

    both = (True, False)
    return [
        ("K5 mod", both, REPS, STEPS,
         gather(gather_micro.VARIANT_IDS["mod"], x5["src"], x5["src"],
                x5["idx"], x5["src"], STEPS),
         lambda r: gather_micro.kernel_ref("mod", x5["src"], x5["idx"], r),
         True),
        ("K6 hermite_pair", both, REPS, STEPS,
         gather(gather_micro2.VARIANT_IDS["hermite_pair"], s6, s6b,
                x6["idx"], x6["w"], STEPS),
         lambda r: gather_micro2.kernel_ref("hermite_pair", s6, s6b,
                                            x6["idx"], x6["w"], r), False),
        ("K7 hermite_pair", (True,), K7_REPS, gather_micro3.STEPS,
         gather(gather_micro3.VARIANT_IDS["hermite_pair"], s7, s7b,
                x7["idx"], x7["w"], gather_micro3.STEPS),
         lambda r: gather_micro3.kernel_ref("hermite_pair", s7, s7b,
                                            x7["idx"], x7["w"], r), False),
        ("K9 gather", (True,), K9_UNITS, onehot_micro2.STEPS,
         bundle(False, onehot_micro2.STEPS),
         lambda u: gather_hermite_ref(*g, u, False), False),
        ("K8 gather", (True,), (onehot_micro.UNITS,), onehot_micro.STEPS,
         bundle(True, onehot_micro.STEPS),
         lambda u: gather_hermite_ref(*g, u, True), False),
    ]


def measure(libs: dict, dev) -> dict:
    """{label: {"K5 mod shared REPS 64": [trace ms per pass], ...}}: the
    labels in order and then reversed, each source's tiles checked first."""
    runs = {label: {} for label in libs}
    checked = set()
    all_cases = cases(dev)
    for label in list(libs) + list(reversed(libs)):
        lib = libs[label]
        for name, spaces, counts, steps, launch, plain, exact in all_cases:
            for smem in spaces:
                for count in counts:
                    out = torch.empty((ROWS, LANE), dtype=torch.float32,
                                      device=dev)

                    def fn(launch=launch, out=out, count=count, smem=smem,
                           lib=lib):
                        with on_device(out):
                            code = launch(lib, out, count, smem)
                        if code:
                            raise RuntimeError(f"{label}: cudaError {code}")
                        return out

                    key = (f"{name} {'shared' if smem else 'global'} "
                           f"{'UNITS' if 'gather' in name else 'REPS'} "
                           f"{count}")
                    if (label, key) not in checked:
                        got, ref = fn(), plain(count)
                        torch.cuda.synchronize()
                        err = float(((got - ref).pow(2).mean().sqrt()
                                     / ref.pow(2).mean().sqrt()))
                        if (exact and not torch.equal(got, ref)) or err > 1e-6:
                            raise RuntimeError(f"{label} {key}: NRMSE "
                                               f"{err:.3e}")
                        checked.add((label, key))
                    runs[label].setdefault(key, []).append(
                        traced_ms(fn, kernel="_kernel"))
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
    texts = sources(args.source, args.ablations)
    with ThreadPoolExecutor(len(texts)) as pool:
        built = pool.map(lambda kv: (kv[0], compile_source(
            kv[1], kv[0], "micro_gather")), texts.items())
        libs = dict(built)
    results = measure(libs, dev)
    for label, by_case in results.items():
        for case, ms in by_case.items():
            print(json.dumps({"source": label, "case": case,
                              "trace_ms": ms}), flush=True)
    print(json.dumps(card()), flush=True)
    return results


if __name__ == "__main__":
    main()
