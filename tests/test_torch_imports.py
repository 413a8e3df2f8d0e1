"""The port stands alone: no module of it imports JAX, flax, optax, msgpack or mindpose_tpu,
nor the JAX package's CLI helpers (``tools/common``, imported as ``common`` or ``tools``).

It also holds the port's registry apart from the JAX package's, and keeps
the serving path free of the evaluation path's host libraries (cv2, yaml).
"""
import ast
import os
import subprocess
import sys

import pytest
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "mindpose_tpu", "common", "tools")


def _port_files():
    files = [os.path.join(ROOT, name) for name in
             ("chip_smoke.py", "profile_serving.py", "profile_train.py", "grad_precision.py",
              os.path.join("tests", "fixtures", "tiny_coco.py"),
              os.path.join("tests", "fixtures", "eval_checks.py"),
              os.path.join("tests", "fixtures", "ddp_ranks.py"),
              os.path.join("tests", "fixtures", "grouping_sets.py"),
              os.path.join("tests", "fixtures", "mpii.py"))]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "mindpose_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_port_registry_is_its_own():
    from mindpose_tpu.register import entrypoint as jax_entrypoint
    from mindpose_tpu_torch.register import entrypoint, register

    jax_backbone = jax_entrypoint("backbone", "hrnet_w32")
    port_backbone = entrypoint("backbone", "hrnet_w32")
    assert port_backbone.__module__.startswith("mindpose_tpu_torch.")
    assert jax_backbone.__module__.startswith("mindpose_tpu.")
    with pytest.raises(ValueError, match="already registered"):
        register("backbone")(port_backbone)


def test_serving_path_imports_neither_cv2_nor_yaml():
    """In a fresh interpreter, the predictor's import loads no cv2 or yaml."""
    code = ("import sys; import mindpose_tpu_torch.engine.predictor; "
            "print(sorted(m for m in ('cv2', 'yaml') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
