"""The JAX package's tools, run in pieces without importing them whole.

Many JAX tools time their full-size programs when imported, or set up a
compilation cache, so the port's tests never import them: ``jax_defs``
builds a tool's functions from its file's source with ``ast``, taking only
the top-level ``def``s and classes, the constant assignments and any
assignment named in ``assigns``, and binds the names they read to reduced
counterparts. ``jax.numpy`` is seen with ``bfloat16`` read as ``float32``
(``Float32Numpy``), so that both sides compute in float32. ``modules``
replaces what an ``import`` inside the tool's functions returns (a tool
that imports ``mindpose_tpu`` in its body sees ``Proxy`` objects whose
factories build the reduced nets). ``Recorder`` stands in for a tool's
``timeit`` and keeps what each timed program returned.
"""
import ast
import builtins
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Float32Numpy:
    """``jax.numpy`` with ``bfloat16`` read as ``float32``."""

    def __getattr__(self, name):
        return jnp.float32 if name == "bfloat16" else getattr(jnp, name)


class Float64Numpy:
    """``jax.numpy`` with ``bfloat16`` and ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name in ("bfloat16", "float32") else getattr(jnp, name)


class Recorder:
    """What each timed program returned, in order."""

    def __init__(self):
        self.outputs = []

    def timeit(self, f, args, iters=10, fetch=None):
        self.outputs.append(f(*args))
        return 1.0  # ms: the tools divide by it


class Proxy:
    """A module with some of its names replaced."""

    def __init__(self, module, **names):
        self._module = module
        self.__dict__.update(names)

    def __getattr__(self, name):
        return getattr(self._module, name)


def _constant(node: ast.Assign) -> bool:
    try:
        ast.literal_eval(node.value)
        return True
    except ValueError:
        return False


def _importer(modules: dict):
    real = builtins.__import__

    def importer(name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and name in modules:
            if fromlist or "." not in name:
                return modules[name]
        return real(name, globals, locals, fromlist, level)

    return importer


def jax_defs(name: str, body_of: str = "", numpy_=None, path: str = "", assigns=(),
             modules=None, **names) -> dict:
    """The top-level defs, classes and constant assignments of
    ``tools/<name>.py`` (or of ``path``, or of the function ``body_of``), and
    the assignments to the names in ``assigns``, executed with ``names``
    bound, ``jnp`` seen as ``numpy_`` (default: bfloat16 read as float32)
    and the imports of ``modules`` replaced; nothing else of the file runs."""
    path = path or os.path.join(REPO, "tools", f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    nodes = tree.body
    if body_of:
        nodes = next(n for n in nodes if isinstance(n, ast.FunctionDef) and n.name == body_of).body
    keep = [n for n in nodes if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            or (isinstance(n, ast.Assign) and (_constant(n) or any(
                isinstance(t, ast.Name) and t.id in assigns for t in n.targets)))]
    ns = {"__name__": f"jax_tool_{name}", "jax": jax, "lax": jax.lax,
          "jnp": numpy_ or Float32Numpy(), "np": np,
          "os": os, "time": time, "print": lambda *a, **k: None, **names}
    if modules:
        ns["__builtins__"] = dict(vars(builtins), __import__=_importer(modules))
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    return ns
