"""The port's public API against the JAX package's, name by name.

Both packages are read with ``ast`` (neither is imported, so this file
needs no JAX).  For each module of ``ogl_beamforming_tpu/`` (one case
each), every public top-level function and class, and every public method
of a public class, must have a counterpart of the same name in the port's
module of the same path, whose parameters hold the JAX package's names
(the port may add more, ``device`` say).  A class's parameters are its
``__init__``'s, or a dataclass's fields; a JAX field may be a property of
the port's class.  A name the port gives another meaning, or another home,
is on :data:`EXCEPTIONS` instead, with the port's counterpart and the
reason; an entry whose name the port now has fails.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX = REPO / "ogl_beamforming_tpu"
PORT = REPO / "ogl_beamforming_tpu_torch"

PALLAS_ONLY = {"interpret"}
"""Parameters of the Pallas launchers with no CUDA meaning (Pallas's
interpret mode): a launcher's counterpart need not take them."""

EXCEPTIONS = {
    "ops/das_pallas.py": (
        "ops/das_cuda.py",
        "the Pallas DAS module: the CUDA kernel's launcher, knob tables "
        "and autotune live in das_cuda"),
    "ops/das_pallas.py:das_pallas": (
        "ops/das_cuda.py:das_cuda", "the Pallas kernel's launcher"),
    "ops/das_pallas.py:das_forces_pallas": (
        "ops/das_cuda.py:das_cuda",
        "the FORCES Pallas launcher; one CUDA launcher takes every family"),
    "ops/das_pallas.py:das_table_static": (
        "ops/das_cuda.py:launch_tables",
        "the Pallas tile tables' shape; K1's tables are built per plan"),
    "ops/das_pallas.py:das_activity_tables": (
        "ops/das_cuda.py:launch_tables",
        "the Pallas tile activity tables; K1's launch tables take their "
        "place"),
    "ops/decode.py:decode_hadamard_pallas": (
        "ops/decode.py:decode_hadamard_cuda",
        "the Pallas decode's launcher"),
    "ops/demod_pallas.py:demodulate_pallas": (
        "ops/filtering.py:demodulate_cuda",
        "the Pallas demodulate launcher; K3's is in filtering"),
    "ops/demod_pallas.py:fir_pallas": (
        "ops/filtering.py:fir_cuda",
        "the Pallas FIR launcher; K4's is in filtering"),
    "utils/transfer.py": (
        "utils/device.py",
        "JAX array transfers; the port's device helpers hold to_host and "
        "sync"),
}
"""``"jax module"`` or ``"jax module:name"`` -> (the port's counterpart,
``"module"`` or ``"module:name"``, and why it is not the same name)."""

MAX_EXCEPTIONS = 12

JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += ["*" + a.vararg.arg] if a.vararg else []
    names += ["**" + a.kwarg.arg] if a.kwarg else []
    return [n for n in names if n not in ("self", "cls")]


def _is_property(fn: ast.FunctionDef) -> bool:
    return any(isinstance(d, ast.Name) and d.id == "property"
               for d in fn.decorator_list)


def surface(path: Path) -> dict:
    """{public name: (parameter names, property names)} of the module at
    ``path``: its top-level functions, classes and their public methods,
    and aliases (``name = function``) of its functions."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out: dict = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = (_params(node), set())
        elif isinstance(node, ast.ClassDef):
            defs = [s for s in node.body
                    if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))]
            init = [d for d in defs if d.name == "__init__"]
            fields = [s.target.id for s in node.body
                      if isinstance(s, ast.AnnAssign)
                      and isinstance(s.target, ast.Name)]
            out[node.name] = (_params(init[0]) if init else fields,
                              {d.name for d in defs if _is_property(d)})
            for d in defs:
                if not d.name.startswith("_"):
                    out[f"{node.name}.{d.name}"] = (_params(d), set())
        elif isinstance(node, ast.Assign) and isinstance(node.value,
                                                         ast.Name):
            for t in node.targets:
                if isinstance(t, ast.Name) and node.value.id in out:
                    out[t.id] = out[node.value.id]
    return {k: v for k, v in out.items()
            if not k.split(".")[0].startswith("_")}


def _missing(want: list[str], have: tuple) -> list[str]:
    params, props = have
    return [n for n in want if n not in params and n not in props]


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_public_api_has_a_counterpart(rel):
    """Every public function, class and method of the JAX module ``rel``
    has a counterpart in the port with the JAX package's parameter names,
    or an entry on :data:`EXCEPTIONS` naming the port's counterpart."""
    port_rel = rel
    if rel in EXCEPTIONS:
        assert not (PORT / rel).exists(), \
            f"{rel} is on the exception list, but the port has the module"
        port_rel = EXCEPTIONS[rel][0]
    # a module the port has no file for: each of its names needs an entry
    ours = surface(PORT / port_rel) if (PORT / port_rel).exists() else {}
    problems = []
    for name, (params, _) in surface(JAX / rel).items():
        key = f"{rel}:{name}"
        if key in EXCEPTIONS:
            if name in ours:
                problems.append(f"{key} is on the exception list, but "
                                f"{port_rel} has {name}")
                continue
            target_rel, target = EXCEPTIONS[key][0].split(":")
            theirs = surface(PORT / target_rel)
            if target not in theirs:
                problems.append(f"{key}: counterpart {target_rel}:{target} "
                                f"missing")
                continue
            lack = _missing([p for p in params if p not in PALLAS_ONLY],
                            theirs[target])
        elif name not in ours:
            problems.append(f"{key}: no counterpart in {port_rel}")
            continue
        else:
            lack = _missing(params, ours[name])
        if lack:
            problems.append(f"{key}: the port's counterpart lacks the "
                            f"parameters {lack}")
    assert not problems, "\n".join(problems)


def test_exception_list_is_short_and_current():
    """At most :data:`MAX_EXCEPTIONS` entries, each naming a JAX module or
    public name that exists, with a port counterpart and a reason."""
    assert len(EXCEPTIONS) <= MAX_EXCEPTIONS
    for key, (target, reason) in EXCEPTIONS.items():
        rel, _, name = key.partition(":")
        assert (JAX / rel).exists(), key
        assert not name or name in surface(JAX / rel), key
        assert reason and "\n" not in reason, key
        target_rel, _, target_name = target.partition(":")
        assert (PORT / target_rel).exists(), target
        assert not target_name or target_name in surface(PORT / target_rel)


def test_surface_reads_what_it_should(tmp_path):
    """The reader finds functions, classes (``__init__`` or dataclass
    fields, properties), public methods and aliases, and leaves out
    private names."""
    src = tmp_path / "m.py"
    src.write_text(
        "def f(a, b=1, *args, c, **kw): pass\n"
        "def _g(x): pass\n"
        "g = f\n"
        "class K:\n"
        "    x: int\n"
        "    y: int = 0\n"
        "    @property\n"
        "    def z(self): return 1\n"
        "    def m(self, q): pass\n"
        "    def _n(self): pass\n"
        "class L:\n"
        "    def __init__(self, d): pass\n"
        "class _M: pass\n")
    s = surface(src)
    assert s["f"] == (["a", "b", "c", "*args", "**kw"], set())
    assert s["g"] == s["f"]
    assert s["K"] == (["x", "y"], {"z"})
    assert s["K.m"] == (["q"], set()) and s["K.z"] == ([], set())
    assert s["L"] == (["d"], set())
    assert set(s) == {"f", "g", "K", "K.m", "K.z", "L"}
