"""The one-hot kernel (K8, K9) of other ``micro_onehot.cu`` sources timed
beside this one's, on Hopper: an older commit's source, and ablations of
this one, each made by replacing a line of it.

Each source is compiled alone (the library's nvcc flags) into a library of
its own under ``_build/`` and launched through its ``micro_onehot`` entry
point, at K8's shape (UNITS 16, STEPS 256) and K9's (UNITS 28, STEPS 2048)
and B = 8, 32, 128, the sources in the order given and then reversed (A, B,
B, A): CUDA events (median and interquartile range of 21 single launches)
and the kernel time of a profiler trace.  Each output is held against the
plain version (NRMSE 1e-6), except an ablation's, whose change breaks it.

  serial      unit u + 1's band is written after unit u's product has
              finished (``wgmma.wait_group 0``): build and product no
              longer overlap
  no_band     no band is written in the loop: the products and the loop's
              waits and barriers alone
  no_product  no wgmma is issued: the band, waits and barriers alone

Run on the card, from the repository root:

    python -m ogl_beamforming_tpu_torch.experiments.onehot_ab \\
        [--source parent=OLD/micro_onehot.cu ...] [--ablations]
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from ..utils.device import launch_stream, on_device
from . import (ONEHOT_BATCHES, ab_sources, call_times, card,
               check_onehot_args, compile_source, onehot_ref, require_gpu,
               traced_ms)
from . import onehot_micro, onehot_micro2

ABLATIONS = {
    "serial": [("wgmma_wait<1>();", "wgmma_wait<0>();")],
    "no_band": [("      store(prev, true);", ""),
                ("      store(next, false);", "")],
    "no_product": [("      wgmma_bf16<B>(acc,", "      if (false) wgmma_bf16<B>(acc,")],
}
"""{name: [(text of the source, its replacement)]}."""
FORMS = {"K8": (True, onehot_micro.UNITS, onehot_micro.STEPS),
         "K9": (False, onehot_micro2.UNITS_SWEEP[-1], onehot_micro2.STEPS)}


def sources(others: list[str], ablations: bool) -> dict:
    """{label: (source text, checked)}: the ``LABEL=PATH`` sources of
    ``others``, this tree's ``micro_onehot.cu`` ("change") and, with
    ``ablations``, the ablations of it, whose outputs are not checked."""
    return {label: (text, label not in ABLATIONS)
            for label, text in ab_sources(
                "micro_onehot.cu", others,
                ABLATIONS if ablations else {}).items()}


def measure(libs: dict, x: dict) -> dict:
    """{label: {form: {B: [{"ms", "iqr_ms", "trace_ms"} per pass]}}}: the
    labels in order and then reversed, each launch checked where its
    source is."""
    order = list(libs) + list(reversed(libs))
    results = {label: {f: {b: [] for b in ONEHOT_BATCHES} for f in FORMS}
               for label in libs}
    errors = {}
    for label in order:
        lib, checked = libs[label]
        for form, (k8, units, steps) in FORMS.items():
            for b in ONEHOT_BATCHES:
                rf = x[f"rf{b}"]
                check_onehot_args(rf, x["kvox"], x["wt4"])
                out = torch.empty_like(rf)

                def fn(lib=lib, rf=rf, out=out, k8=k8, units=units,
                       steps=steps):
                    with on_device(rf):
                        code = lib.micro_onehot(
                            rf.shape[0], int(k8), rf.data_ptr(),
                            x["kvox"].data_ptr(), x["wt4"].data_ptr(),
                            out.data_ptr(), units, steps, launch_stream(rf))
                    if code:
                        raise RuntimeError(f"{label}: cudaError {code}")
                    return out

                if checked and (label, form, b) not in errors:
                    ref = onehot_ref(rf, x["kvox"], x["wt4"], units, k8)
                    got = fn()
                    torch.cuda.synchronize()
                    err = float(((got - ref).pow(2).mean().sqrt()
                                 / ref.pow(2).mean().sqrt()))
                    if err > 1e-6:
                        raise RuntimeError(f"{label} {form} B={b}: NRMSE "
                                           f"{err:.3e} > 1e-6")
                    errors[(label, form, b)] = err
                times = call_times({0: fn})[0]
                q1, med, q3 = statistics.quantiles(times, n=4)
                results[label][form][b].append(
                    {"ms": med, "iqr_ms": q3 - q1,
                     "trace_ms": traced_ms(fn, kernel="onehot_kernel")})
    return results


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="LABEL=PATH", help="another micro_onehot.cu to "
                    "time beside this tree's (an older commit's), timed first")
    ap.add_argument("--ablations", action="store_true",
                    help="also the ablations of this tree's source")
    args = ap.parse_args(argv)
    dev = require_gpu(device)
    x = onehot_micro.make_inputs(dev)
    print(json.dumps(card()), flush=True)
    libs = {label: (compile_source(text, label, "micro_onehot"), checked)
            for label, (text, checked) in sources(args.source,
                                                  args.ablations).items()}
    results = measure(libs, x)
    for label, forms in results.items():
        for form, by_b in forms.items():
            for b, runs in by_b.items():
                print(json.dumps({"source": label, "form": form, "B": b,
                                  "runs": runs}), flush=True)
    print(json.dumps(card()), flush=True)
    return results


if __name__ == "__main__":
    main()
