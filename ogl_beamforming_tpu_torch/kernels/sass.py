"""Static SASS counts of the DAS kernels' inner pair loop.

``cuobjdump -sass`` of a built library (or of one ``.cu`` source compiled to
a cubin for ``sm_90a``) is split into functions; in each
``das_forces_kernel`` instantiation the innermost loops that load RF samples
(``LDG``) are found from the backward branches, and the one with the most
loads -- the unrolled body of the pair loop -- is counted: its instructions,
its ``LDG``, ``LDS`` and ``MUFU`` instructions, and its instructions per
candidate pair (the body holds ``LDG / (taps x frames)`` pairs, counting
only 64-bit loads for IQ samples).  The
counts are static: a pair outside the tap window branches past most of
the body.

``rotation_share`` compiles a source twice, once as it is and once with the
IQ rotation's phase (``sincosf`` of the twin's argument) replaced by the
identity, and returns the share of the IQ pair body that the rotation takes.

Run on a machine with the CUDA toolkit, from the repository root:

    python -m ogl_beamforming_tpu_torch.kernels.sass             # built library
    python -m ogl_beamforming_tpu_torch.kernels.sass --source F.cu [--rotation]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from . import build

_FORCES = re.compile(r"das_forces_kernelILi(\d)ELb([01])ELb([01])ELi(\d)E")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA(?:\.\S+)?\s+(?:`?\(?)(0x[0-9a-f]+|\.L_x_\d+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_PHASE = ("if constexpr (IQ) sincosf(__fmul_rn(two_pi_fd, __fdiv_rn(index, fs)), "
          "&sn, &cs);")
TAPS = {0: 1, 1: 2, 2: 4}          # RF loads per frame of a pair, by mode
MODES = {0: "nearest", 1: "linear", 2: "cubic"}


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / name)


def dump(binary) -> str:
    """``cuobjdump -sass`` of a shared library or cubin."""
    return subprocess.run([_tool("cuobjdump"), "-sass", str(binary)],
                          capture_output=True, text=True, timeout=600,
                          check=True).stdout


def compile_sass(source, workdir) -> tuple[str, str]:
    """SASS of one ``.cu`` source compiled for ``sm_90a`` (the library's
    flags) into a cubin under ``workdir``, and the compiler's report."""
    cubin = Path(workdir) / (Path(source).stem + ".cubin")
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    proc = subprocess.run([build.find_nvcc(), *flags, "-cubin", "-o",
                           str(cubin), str(source)], capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise build.KernelBuildError(f"nvcc -cubin {source} failed:\n"
                                     f"{proc.stdout}{proc.stderr}")
    return dump(cubin), proc.stdout + proc.stderr


def ptxas_usage(log: str) -> dict:
    """{mangled name: (registers, spill stores + loads in bytes)} from an
    ``nvcc -Xptxas -v`` log."""
    out: dict = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = int(m.group(1)) + int(m.group(2))
            out[name] = (out.get(name, (0, 0))[0], spills)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), out.get(name, (0, 0))[1])
    return out


def functions(text: str) -> dict:
    """{mangled name: ([(address, instruction)], {label: address})} of
    every function."""
    out: dict = {}
    instrs: list = []
    labels: dict = {}
    pending: list = []
    for line in text.splitlines():
        if "Function :" in line:
            instrs, labels, pending = [], {}, []
            out[line.split("Function :", 1)[1].strip()] = (instrs, labels)
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m and out:
            addr = int(m.group(1), 16)
            labels.update((lab, addr) for lab in pending)
            pending = []
            instrs.append((addr, m.group(2)))
    return out


def _op(instr: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", instr).split()[0]


def _is_load(op: str, wide: bool) -> bool:
    return op.startswith("LDG") and (not wide or ".64" in op)


def inner_loop(instrs, labels=None, min_loads=1, wide=False) -> dict | None:
    """Counts of the pair loop: of the loops that hold at least
    ``min_loads`` sample loads (``LDG``, 64-bit ones if ``wide``) and do
    float arithmetic, the innermost one with the most loads, without the
    loops nested in it (the integer loop of sincosf's slow argument
    reduction, whose table loads are also ``LDG``)."""
    labels = labels or {}
    loops = []
    for addr, ins in instrs:
        m = _BRA.search(ins)
        if not m:
            continue
        tgt = m.group(1)
        target = int(tgt, 16) if tgt.startswith("0x") else labels.get(tgt)
        if target is not None and target <= addr:
            loops.append((target, addr))

    def ops(lo, hi, skip=()):
        return [_op(ins) for a, ins in instrs if lo <= a <= hi
                and not any(l2 <= a <= h2 for l2, h2 in skip)]

    def inside(lo, hi, cands):
        return [(l2, h2) for l2, h2 in cands
                if (l2, h2) != (lo, hi) and lo <= l2 and h2 <= hi]

    def loads(lo, hi):
        return sum(_is_load(o, wide) for o in ops(lo, hi))

    cands = [(lo, hi) for lo, hi in loops
             if loads(lo, hi) >= min_loads
             and any(o.startswith(("FADD", "FFMA", "FMUL"))
                     for o in ops(lo, hi))]
    inner = [lh for lh in cands if not inside(*lh, cands)]
    if not inner:
        return None
    best = max(inner, key=lambda lh: loads(*lh))
    nested = inside(*best, loops)
    body = ops(*best, skip=nested)
    return {"instructions": len(body),
            "nested": len(ops(*best)) - len(body),
            "LDG": sum(o.startswith("LDG") for o in body),
            "loads": sum(_is_load(o, wide) for o in body),
            "LDS": sum(o.startswith("LDS") for o in body),
            "MUFU": sum(o.startswith("MUFU") for o in body),
            "CALL": sum(o.startswith("CALL") for o in body)}


def forces_loops(text: str) -> dict:
    """{"<mode> <real|iq>[ coh] fb<N>": counts} of every das_forces_kernel
    instantiation in ``text``, with ``per_pair`` instructions."""
    out = {}
    for name, (instrs, labels) in functions(text).items():
        m = _FORCES.search(name)
        if not m:
            continue
        mode, iq, coh, fb = (int(g) for g in m.groups())
        # an IQ sample is a 64-bit load; sincosf's table loads are 32-bit
        counts = inner_loop(instrs, labels, TAPS[mode] * fb, bool(iq))
        if counts is None:
            continue
        counts["pairs"] = counts["loads"] / (TAPS[mode] * fb)
        counts["per_pair"] = counts["instructions"] / counts["pairs"]
        key = (f"{MODES[mode]} {'iq' if iq else 'real'}"
               f"{' coh' if coh else ''} fb{fb}")
        out[key] = counts
    return out


def rotation_share(source) -> dict:
    """Per IQ instantiation: instructions per pair with and without the
    rotation's phase, and the share the rotation takes."""
    text = Path(source).read_text()
    if _PHASE not in text:
        raise ValueError(f"{source}: the IQ phase line was not found")
    with tempfile.TemporaryDirectory() as tmp:
        full = forces_loops(compile_sass(source, tmp)[0])
        stub = Path(tmp) / "das_no_phase.cu"
        stub.write_text(text.replace(_PHASE, "sn = 0.f; cs = 1.f;"))
        bare = forces_loops(compile_sass(stub, tmp)[0])
    out = {}
    for key, c in full.items():
        if " iq" in key and key in bare:
            with_rot, without = c["per_pair"], bare[key]["per_pair"]
            out[key] = {"per_pair": with_rot, "without_rotation": without,
                        "rotation_share": 1.0 - without / with_rot}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", help="a .cu file to compile and count "
                    "(default: the built library)")
    ap.add_argument("--rotation", action="store_true",
                    help="also the IQ rotation's share (needs --source)")
    args = ap.parse_args()
    if args.source:
        with tempfile.TemporaryDirectory() as tmp:
            text, log = compile_sass(args.source, tmp)
    else:
        lib = build.build()
        text, log = dump(lib), lib.with_suffix(".log").read_text()
    usage = {m.group(0): v for k, v in ptxas_usage(log).items()
             for m in [_FORCES.search(k)] if m}
    result = {"forces_inner_loop": forces_loops(text),
              "forces_registers_spills": usage}
    if args.rotation:
        if not args.source:
            ap.error("--rotation needs --source")
        result["rotation"] = rotation_share(args.source)
    print(json.dumps(result, indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
