"""The port stands alone: no module of it imports JAX, flax, optax or mindpose_tpu.

It also holds the port's registry apart from the JAX package's.
"""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mindpose_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "profile_serving.py")]
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
