"""Static SASS counts of the DAS kernels' inner pair loop, and of the int8
tensor-core kernels.

``cuobjdump -sass`` of a built library (or of one ``.cu`` source compiled to
a cubin for ``sm_90a``) is split into functions; in each instantiation of
``das_forces_kernel``, ``das_hercules_kernel`` and ``das_rca_kernel`` the
innermost loops that load RF samples (``LDG``) are found from the backward
branches, and the one with the most loads -- the unrolled body of the pair
loop -- is counted: its instructions, its ``LDG``, ``LDS`` and ``MUFU``
instructions, and its instructions per candidate pair (the body holds
``LDG / (taps x frames)`` pairs, counting only 64-bit loads for IQ
samples; a HERCULES or RCA body of several voxels per thread holds one pair
per voxel, so its shared part is divided among them).  The counts are
static: a pair outside the mask or the tap window branches past most of the
body.

``rotation_share`` compiles a source twice, once as it is and once with the
IQ rotation's phase (``sincosf`` of the twin's argument) replaced by the
identity, and returns the share of the IQ pair body that the rotation takes.

Run on a machine with the CUDA toolkit, from the repository root:

    python -m ogl_beamforming_tpu_torch.kernels.sass             # built library
    python -m ogl_beamforming_tpu_torch.kernels.sass --source F.cu [--rotation]

``--source`` counts another ``das.cu`` (an older commit's, say) the same
way.  :func:`onehot_loops` counts the unit loop of each instantiation of
``onehot_kernel`` (``csrc/micro_onehot.cu``).  :func:`kernel_counts`
counts each instantiation of the int8 skeleton's
kernels (``decode_i8_kernel``, ``i8_mma_kernel``) whole: its instructions,
MMAs, ``ldmatrix``, ``cp.async`` and the rest of :data:`I8_OPS`.
``--source F.cu --same-as G.cu`` also says, for each int8 kernel and each
instantiation of the filter kernels (``demodulate_kernel``, ``fir_kernel``),
of K7's and the K8/K9 bundle's gather kernel (``gather_walk_kernel``), of
the DAS kernels and of the float32 decode kernel that both compile, whether
its SASS is the same
instruction for instruction (the decode kernel of an older ``decode.cu``
against the current one, say):

    python -m ogl_beamforming_tpu_torch.kernels.sass \
        --source ogl_beamforming_tpu_torch/csrc/decode.cu --same-as OLD.cu

:func:`gather_loops` counts the repetition loop, the unit loop around it
and the code outside every loop of each instantiation of
``gather_floor_kernel`` (K5, K6) and ``gather_walk_kernel`` (K7, the bundle)
(``csrc/micro_gather.cu``) by kind of instruction, for the
microbenchmarks' diagnosis.
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

FAMILIES = ("forces", "hercules", "rca")
_DAS = re.compile(r"das_(forces|hercules|rca)_kernel"
                  r"ILi(\d)ELb([01])ELb([01])ELi(\d)E"
                  r"(?:Li(\d+)ELi(\d+)ELb([01])E)?")
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


def pair_loops(text: str, family: str = "forces") -> dict:
    """{"<mode> <real|iq>[ coh] fb<N>": counts} of every instantiation of
    ``das_<family>_kernel`` in ``text``, with ``per_pair`` instructions."""
    out = {}
    for name, (instrs, labels) in functions(text).items():
        m = _DAS.search(name)
        if not m or m.group(1) != family:
            continue
        mode, iq, coh, fb = (int(g) for g in m.groups()[1:5])
        shape = (tuple(int(g) for g in m.groups()[5:])
                 if m.group(6) is not None else None)
        # an IQ sample is a 64-bit load; sincosf's table loads are 32-bit
        counts = inner_loop(instrs, labels, TAPS[mode] * fb, bool(iq))
        if counts is None:
            continue
        counts["pairs"] = counts["loads"] / (TAPS[mode] * fb)
        counts["per_pair"] = counts["instructions"] / counts["pairs"]
        key = (f"{MODES[mode]} {'iq' if iq else 'real'}"
               f"{' coh' if coh else ''} fb{fb}")
        if shape is not None and shape != build.THREAD_SHAPES[family][0]:
            # another thread shape than the family's default
            key += " t{}.{}.{}".format(*shape)
        out[key] = counts
    return out


I8_OPS = ("IMMA", "LDSM", "LDGSTS", "PRMT", "LDS", "SHFL", "STG")
"""The instructions of the int8 tensor-core skeleton (``csrc/i8_mma.cuh``)
that :func:`kernel_counts` counts: the MMAs, ``ldmatrix``, ``cp.async``,
byte permutes, shared loads, shuffles and stores."""
_I8 = re.compile(r"(decode_i8_kernel|i8_mma_kernel)ILi(\d)E(?:Li(\d)ELi(\d+)ELi(\d+)"
                 r"ELi(\d+)E)?")


def i8_key(name: str) -> str | None:
    """"<kernel> k<steps>[ b<body> wn<WN> wm<WM> rows<ROWS>]" of a mangled
    name of the int8 skeleton's kernels (the template arguments of
    ``csrc/i8_mma.cuh``; body 0 the decode's, 1 the high half alone, 2 and
    3 K10's int32 and float32 pairs), None for any other."""
    m = _I8.search(name)
    if not m:
        return None
    return f"{m.group(1)} k{m.group(2)}" + (
        "" if m.group(3) is None else
        " b{} wn{} wm{} rows{}".format(*m.groups()[2:]))


def kernel_counts(text: str) -> dict:
    """{:func:`i8_key`: counts} of every instantiation of the int8
    skeleton's kernels (``decode_i8_kernel`` and ``i8_mma_kernel``) in
    ``text``: all static instructions of the function and those of
    :data:`I8_OPS`."""
    out = {}
    for name, (instrs, _) in functions(text).items():
        key = i8_key(name)
        if key is None:
            continue
        ops = [_op(ins).split(".")[0] for _, ins in instrs]
        out[key] = {"instructions": len(ops),
                    **{op: ops.count(op) for op in I8_OPS}}
    return out


ONEHOT_OPS = ("HGMMA", "HMMA", "STS", "LDS", "BAR", "WARPGROUP")
"""The instructions of the one-hot kernel's unit loop that
:func:`onehot_loops` counts: the tensor-core products (``wgmma`` as
``HGMMA``, ``mma.sync`` as ``HMMA``), the band's shared stores, shared
loads, barriers and the ``wgmma`` fences and waits."""
_ONEHOT = re.compile(r"onehot_kernelILi(\d+)E")


def onehot_loops(text: str) -> dict:
    """{B: counts} of the unit loop of every instantiation of
    ``onehot_kernel`` (``csrc/micro_onehot.cu``) in ``text``: the innermost
    loop that holds a tensor-core product, its instructions and those of
    :data:`ONEHOT_OPS`; None for an instantiation with no such loop."""
    out = {}
    for name, (instrs, labels) in functions(text).items():
        m = _ONEHOT.search(name)
        if not m:
            continue
        ops = [(addr, _op(ins).split(".")[0]) for addr, ins in instrs]
        loops = []
        for addr, ins in instrs:
            b = _BRA.search(ins)
            if not b:
                continue
            tgt = b.group(1)
            target = int(tgt, 16) if tgt.startswith("0x") else labels.get(tgt)
            if target is not None and target <= addr and any(
                    target <= a <= addr and op in ("HGMMA", "HMMA")
                    for a, op in ops):
                loops.append((target, addr))
        if not loops:
            out[int(m.group(1))] = None
            continue
        lo, hi = min(loops, key=lambda lh: lh[1] - lh[0])
        body = [op for a, op in ops if lo <= a <= hi]
        out[int(m.group(1))] = {"instructions": len(body),
                                **{op: body.count(op) for op in ONEHOT_OPS}}
    return out


GATHER_FLOAT = ("FADD", "FMUL", "FFMA")
GATHER_INTEGER = ("IADD3", "IMAD", "ISETP", "LOP3", "SHF", "LEA", "SEL",
                  "IMNMX", "VIMNMX", "PRMT", "IABS", "MOV")
GATHER_CONVERT = ("I2F", "F2I", "I2FP", "F2IP")
"""The kinds of instruction that :func:`gather_loops` counts: float adds
and products (also each of the three alone), integer and move
instructions, and conversions."""
_GATHER = re.compile(r"gather_(floor|walk)_kernelILi(\d+)ELb([01])E")


_STEP = re.compile(r"^(?:U?IADD3|VIADD)\s+(U?R\d+),\s*\1,\s*(0x[0-9a-f]+|\d+)"
                   r"\s*(?:,|$)")


def _gather_counts(ops) -> dict:
    kinds = [o.split(".")[0] for o in ops]
    return {"instructions": len(ops),
            "LDS": kinds.count("LDS"), "LDG": kinds.count("LDG"),
            "LDS128": sum(o.startswith("LDS.128") for o in ops),
            "float": sum(k in GATHER_FLOAT for k in kinds),
            **{k: kinds.count(k) for k in GATHER_FLOAT},
            "integer": sum(k in GATHER_INTEGER for k in kinds),
            "convert": sum(k in GATHER_CONVERT for k in kinds)}


def gather_loops(text: str) -> dict:
    """{(variant id, shared memory): counts} of every instantiation of
    ``gather_floor_kernel`` (K5, K6) and ``gather_walk_kernel`` (K7, the
    K8/K9 bundle) (``csrc/micro_gather.cu``) in ``text``.  ``body``: the
    repetition loop, or a walk's turn loop (of the innermost loops with
    float arithmetic, the one with the most), its instructions and of them
    ``LDS`` (and of those the 16-byte ``LDS128``), ``LDG``, ``float``
    (:data:`GATHER_FLOAT`; also ``FADD``, ``FMUL`` and ``FFMA`` alone),
    ``integer`` (:data:`GATHER_INTEGER`) and ``convert``
    (:data:`GATHER_CONVERT`); ``step``: the repetitions a turn of it takes
    (the immediate its counter adds: 8 a turn of the source's loop, more
    where the compiler unrolled it; None where no counter adds an
    immediate); ``unit``: the same counts of the innermost loop around it
    (the loop over a warp's units), without the loops nested in it, each
    executed once a unit; None where no loop holds the repetition loop;
    ``tail``: the same counts of the other loops with float arithmetic in
    the unit loop (a walk's tail loop), None where there is none;
    ``outside``: the same counts of the instructions in no loop, each
    executed once a warp (so the staging loop or wait and the lane dealing
    are left out: a lower bound)."""
    out = {}
    for name, (instrs, labels) in functions(text).items():
        m = _GATHER.search(name)
        if not m:
            continue
        loops = []
        for addr, ins in instrs:
            b = _BRA.search(ins)
            if not b:
                continue
            tgt = b.group(1)
            target = int(tgt, 16) if tgt.startswith("0x") else labels.get(tgt)
            if target is not None and target <= addr:
                loops.append((target, addr))

        def within(lh, outer):
            return outer[0] <= lh[0] and lh[1] <= outer[1] and lh != outer

        def own(lh):
            """The instructions of loop ``lh`` outside the loops in it."""
            return [_op(ins) for a, ins in instrs if lh[0] <= a <= lh[1]
                    and not any(lo <= a <= hi for lo, hi in loops
                                if within((lo, hi), lh))]

        def floats(lh):
            return sum(o.split(".")[0] in GATHER_FLOAT for o in own(lh))

        inner = [lh for lh in loops
                 if floats(lh) and not any(within(o, lh) for o in loops)]
        main = max(inner, key=floats, default=None)
        body = [] if main is None else own(main)
        around = [lh for lh in loops if main is not None and within(main, lh)]
        unit = min(around, key=lambda lh: lh[1] - lh[0], default=None)
        tails = [] if unit is None else [
            lh for lh in loops if lh != main and within(lh, unit)
            and floats(lh) and not within(main, lh)]
        step = None
        for op_ins in ([] if main is None else
                       [ins for a, ins in instrs if main[0] <= a <= main[1]]):
            st = _STEP.match(re.sub(r"^@!?U?P\w+\s+", "", op_ins))
            if st and int(st.group(2), 0) < 1 << 31:   # not a down-count
                step = int(st.group(2), 0)
        out[(int(m.group(2)), m.group(3) == "1")] = {
            "kernel": f"gather_{m.group(1)}_kernel",
            "body": _gather_counts(body), "step": step,
            "unit": None if unit is None else _gather_counts(own(unit)),
            "tail": _gather_counts([o for lh in tails for o in own(lh)])
            if tails else None,
            "outside": _gather_counts(
                [_op(ins) for a, ins in instrs
                 if not any(lo <= a <= hi for lo, hi in loops)])}
    return out


_FILTER = re.compile(r"(demodulate|fir)_kernelI(.+?)EEv")


_SAME_GATHER = re.compile(r"(gather_walk_kernel)I(.+?)EEv")
_SAME_TUNED = re.compile(r"(das_(?:forces|hercules|rca)_kernel|"
                         r"decode_f32_kernel|decode_i8_tile_kernel)"
                         r"I(.+?)EEv")


def same_key(name: str) -> str | None:
    """:func:`i8_key` of an int8 kernel, "<demodulate|fir> <template
    arguments as mangled>" of a filter kernel, "gather_walk_kernel
    <template arguments>" of K7's and the K8/K9 bundle's kernel
    (``csrc/micro_gather.cu``), the same of each DAS kernel
    (``das_<family>_kernel``; a default thread shape keyed without it) and
    of the decode kernels' other instantiations (``decode_f32_kernel``,
    ``decode_i8_tile_kernel``), None for any other."""
    m = (_FILTER.search(name) or _SAME_GATHER.search(name)
         or _SAME_TUNED.search(name))
    if m is None:
        return i8_key(name)
    args = m.group(2)
    d = _DAS.search(name)
    if d is not None and d.group(6) is not None and tuple(
            int(g) for g in d.groups()[5:]) == build.THREAD_SHAPES[
                d.group(1)][0]:
        # a default thread shape's kernel keeps the key it had before the
        # shape was a template argument
        args = args[:-len("Li{}ELi{}ELb{}E".format(*d.groups()[5:]))]
    return i8_key(name) or f"{m.group(1)} {args}"


def same_as(source, other) -> dict:
    """{:func:`same_key`: {"same": bool, "reordered": bool,
    "instructions": [n, n_other], "registers": [r, r_other]}} for each
    kernel :func:`same_key` keys that both ``.cu`` sources compile: "same" where
    the two SASS listings are equal instruction for instruction,
    "reordered" where they hold the same instructions in another order."""
    listings = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, src in enumerate((source, other)):
            (Path(tmp) / str(i)).mkdir()
            text, log = compile_sass(src, Path(tmp) / str(i))
            regs = {same_key(k): r for k, (r, _) in ptxas_usage(log).items()}
            listings.append({same_key(name): ([ins for _, ins in instrs],
                                              regs.get(same_key(name)))
                             for name, (instrs, _) in functions(text).items()
                             if same_key(name)})
    mine, theirs = listings
    return {key: {"same": mine[key][0] == theirs[key][0],
                  "reordered": mine[key][0] != theirs[key][0]
                  and sorted(mine[key][0]) == sorted(theirs[key][0]),
                  "instructions": [len(mine[key][0]), len(theirs[key][0])],
                  "registers": [mine[key][1], theirs[key][1]]}
            for key in sorted(mine.keys() & theirs.keys())}


def rotation_share(source) -> dict:
    """Per IQ instantiation: instructions per pair with and without the
    rotation's phase, and the share the rotation takes."""
    text = Path(source).read_text()
    if _PHASE not in text:
        raise ValueError(f"{source}: the IQ phase line was not found")
    with tempfile.TemporaryDirectory() as tmp:
        full = pair_loops(compile_sass(source, tmp)[0])
        stub = Path(tmp) / "das_no_phase.cu"
        stub.write_text(text.replace(_PHASE, "sn = 0.f; cs = 1.f;"))
        bare = pair_loops(compile_sass(stub, tmp)[0])
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
    ap.add_argument("--same-as", metavar="OTHER", help="a second .cu file: "
                    "whether each int8 kernel's SASS is the same in both "
                    "(needs --source)")
    args = ap.parse_args()
    if args.source:
        with tempfile.TemporaryDirectory() as tmp:
            text, log = compile_sass(args.source, tmp)
    else:
        lib = build.build()
        text, log = dump(lib), lib.with_suffix(".log").read_text()
    usage = {m.group(0): v for k, v in ptxas_usage(log).items()
             for m in [_DAS.search(k)] if m}
    result = {"inner_loop": {f: pair_loops(text, f) for f in FAMILIES},
              "registers_spills": usage, "i8_kernels": kernel_counts(text),
              "onehot_unit_loop": onehot_loops(text)}
    if args.rotation:
        if not args.source:
            ap.error("--rotation needs --source")
        result["rotation"] = rotation_share(args.source)
    if args.same_as:
        if not args.source:
            ap.error("--same-as needs --source")
        result["same_as"] = same_as(args.source, args.same_as)
    print(json.dumps(result, indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
