"""Generate a markdown API reference for the public surface.

The reference ships a doxygen target (``/root/reference/docs/CMakeLists.txt``);
this is its in-kind equivalent without external tooling (no sphinx/pdoc in
the environment): introspect the public modules with ``inspect`` and emit
``docs/api/*.md`` — one page per module, signatures + docstrings, plus an
index.

Usage: ``python scripts/gen_apidoc.py``.  Run on CPU (imports jax).
"""

import importlib
import inspect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "docs", "api")

#: the documented public surface (the analog of the doxygen input list)
MODULES = [
    "plssvm_sparse_fp22",
    "plssvm_sparse_fp22.params",
    "plssvm_sparse_fp22.types",
    "plssvm_sparse_fp22.device",
    "plssvm_sparse_fp22.exceptions",
    "plssvm_sparse_fp22.models.base",
    "plssvm_sparse_fp22.models.factory",
    "plssvm_sparse_fp22.solver.cg",
    "plssvm_sparse_fp22.solver.checkpoint",
    "plssvm_sparse_fp22.ops.matvec",
    "plssvm_sparse_fp22.ops.kernel_functions",
    "plssvm_sparse_fp22.ops.sparse",
    "plssvm_sparse_fp22.parallel.mesh",
    "plssvm_sparse_fp22.parallel.sharded",
    "plssvm_sparse_fp22.parallel.distributed",
    "plssvm_sparse_fp22.io.libsvm",
    "plssvm_sparse_fp22.io.arff",
    "plssvm_sparse_fp22.io.model",
    "plssvm_sparse_fp22.cli.train",
    "plssvm_sparse_fp22.cli.predict",
    "plssvm_sparse_fp22.utils.oracle",
    "plssvm_sparse_fp22.utils.timing",
]


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _doc(obj, indent=""):
    doc = inspect.getdoc(obj)
    if not doc:
        return ""
    return "\n".join(indent + line for line in doc.splitlines())


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        if getattr(obj, "__module__", mod.__name__) != mod.__name__ and \
                mod.__name__ != "plssvm_sparse_fp22":
            continue  # re-exports documented at their home module
        out.append((n, obj))
    return out


def render_module(mod):
    lines = [f"# `{mod.__name__}`", ""]
    if mod.__doc__:
        lines += [inspect.cleandoc(mod.__doc__), ""]
    for name, obj in _public_members(mod):
        if inspect.isclass(obj):
            lines += [f"## class `{name}{_sig(obj)}`", ""]
            d = _doc(obj)
            if d:
                lines += [d, ""]
            for mname, meth in inspect.getmembers(obj):
                if mname.startswith("_") or not (
                        inspect.isfunction(meth) or inspect.ismethod(meth)):
                    continue
                lines += [f"### `{name}.{mname}{_sig(meth)}`", ""]
                d = _doc(meth)
                if d:
                    lines += [d, ""]
        elif inspect.isfunction(obj):
            lines += [f"## `{name}{_sig(obj)}`", ""]
            d = _doc(obj)
            if d:
                lines += [d, ""]
        else:
            rep = repr(obj)
            if len(rep) > 120:
                rep = rep[:117] + "..."
            lines += [f"## `{name}` = `{rep}`", ""]
    return "\n".join(lines) + "\n"


def main():
    os.makedirs(OUT, exist_ok=True)
    index = ["# API reference", "",
             "Generated by `python scripts/gen_apidoc.py` (the in-kind "
             "equivalent of the reference's doxygen target).", ""]
    for name in MODULES:
        mod = importlib.import_module(name)
        page = name.replace(".", "_") + ".md"
        with open(os.path.join(OUT, page), "w") as fh:
            fh.write(render_module(mod))
        first = (inspect.cleandoc(mod.__doc__).splitlines()[0]
                 if mod.__doc__ else "")
        index.append(f"- [`{name}`]({page}) — {first}")
    with open(os.path.join(OUT, "index.md"), "w") as fh:
        fh.write("\n".join(index) + "\n")
    print(f"wrote {len(MODULES) + 1} pages under docs/api/")


if __name__ == "__main__":
    main()
