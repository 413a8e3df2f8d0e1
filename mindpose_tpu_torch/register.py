"""Component registry of the port.

A two-level (module, component) name -> factory map, through which configs
resolve backbones, heads and decoders. It has the public semantics of
``mindpose_tpu/register.py`` but its own dictionaries, so a process that
imports both packages keeps the two sets of components apart. Registering a
name twice in one module is an error, not a silent overwrite.
"""
from collections import defaultdict
from typing import Any, Callable, Dict, List

_entrypoints: Dict[str, Dict[str, Callable[..., Any]]] = defaultdict(dict)


def _global_register(module_name: str, name: str, fn: Callable[..., Any]) -> None:
    if name in _entrypoints[module_name]:
        raise ValueError(f"`{name}` is already registered in `{module_name}`")
    _entrypoints[module_name][name] = fn


def register(module_name: str, extra_name: str = "") -> Callable[..., Any]:
    """Register a component factory under ``module_name``.

    The factory is registered with its ``__name__``; if ``extra_name`` is
    given it is registered a second time under that name.
    """

    def wrapper(fn: Callable[..., Any]) -> Callable[..., Any]:
        _global_register(module_name, fn.__name__, fn)
        if extra_name and extra_name != fn.__name__:
            _global_register(module_name, extra_name, fn)
        return fn

    return wrapper


def list_components(module: str) -> List[str]:
    """All registered component names in a module, sorted."""
    return sorted(_entrypoints.get(module, {}))


def list_modules() -> List[str]:
    """All module namespaces that have at least one component."""
    return sorted(m for m, comps in _entrypoints.items() if comps)


def entrypoint(module_name: str, component_name: str) -> Callable[..., Any]:
    """Resolve a (module, component) pair to its factory."""
    if module_name not in _entrypoints:
        raise ValueError(
            f"Unknown module `{module_name}`. Supported modules: {list_modules()}"
        )
    if component_name not in _entrypoints[module_name]:
        raise ValueError(
            f"Unknown component `{component_name}`. Supported components in "
            f"`{module_name}`: {list_components(module_name)}"
        )
    return _entrypoints[module_name][component_name]
