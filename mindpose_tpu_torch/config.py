"""Config system: YAML recipes + argparse + dotted-path CLI overrides.

Copy of ``mindpose_tpu/config.py``: ``--config recipe.yaml`` merges the YAML
into a flat namespace, and ``--cfg-options a.b.c=value`` applies dotted-path
overrides whose values are parsed with ``ast.literal_eval`` (falling back to
raw strings). yaml is imported when a file is parsed, so the serving path
never imports it. ``check_divergent_knobs``, the training entry's gate on
the BatchNorm and optimizer knobs that change training dynamics, is a
copy too. Its ``--seed`` comes with the training CLI, the only one that
reads it.
"""
import argparse
import ast
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["parse_args", "parse_yaml", "set_dotted", "Config", "check_divergent_knobs"]


def check_divergent_knobs(args: Any) -> None:
    """Refuse documented-divergent training knobs unless explicitly allowed.

    ``bn_grad_stats != "exact"`` and ``radial_projection`` change training
    dynamics vs the reference recipe (docs/divergences.md #10, #12; the
    frozen-BN ablation in docs/performance.md diverged after ~15 epochs).
    They exist for experiments only, so the trainer rejects them unless the
    config sets ``allow_divergent_knobs: true``, in which case it warns.
    """
    import logging

    knobs = []
    backbone_setting = getattr(args, "backbone_setting", None) or {}
    grad_stats = backbone_setting.get("bn_grad_stats", "exact")
    # "fused" is exact BN numerics with a hand-written backward — not divergent
    if grad_stats not in ("exact", "fused"):
        knobs.append(f"backbone_setting.bn_grad_stats={grad_stats!r}")
    optimizer_setting = getattr(args, "optimizer_setting", None) or {}
    if optimizer_setting.get("radial_projection"):
        knobs.append("optimizer_setting.radial_projection=True")
    if not knobs:
        return
    if not getattr(args, "allow_divergent_knobs", False):
        raise SystemExit(
            "Divergent training knobs set: "
            + ", ".join(knobs)
            + ". These alter training dynamics vs the reference recipe "
            "(see docs/divergences.md). Set allow_divergent_knobs=true "
            "to proceed anyway."
        )
    for knob in knobs:
        logging.warning(
            "divergent knob enabled: %s — training dynamics will differ "
            "from the reference recipe (docs/divergences.md)", knob
        )


def _literal(value: str) -> Any:
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def set_dotted(cfg: Dict[str, Any], dotted_key: str, value: Any) -> None:
    """Set ``cfg['a']['b']['c'] = value`` for ``dotted_key == 'a.b.c'``."""
    keys = dotted_key.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


class _StoreDictKeyPair(argparse.Action):
    """Parse ``--cfg-options k1=v1 k2.k3=v2`` into a dict."""

    def __call__(self, parser, namespace, values, option_string=None):
        options = getattr(namespace, self.dest, None) or {}
        for kv in values:
            key, _, raw = kv.partition("=")
            options[key] = _literal(raw)
        setattr(namespace, self.dest, options)


def parse_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


class Config(argparse.Namespace):
    """Flat namespace over a config dict, with dict-style access too."""

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return hasattr(self, key)

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def asdict(self) -> Dict[str, Any]:
        return dict(vars(self))


def parse_args(
    argv: Optional[Sequence[str]] = None,
    description: str = "mindpose_tpu_torch",
    extra_args: Optional[List[Dict[str, Any]]] = None,
) -> Config:
    """Parse CLI args: ``--config`` YAML merged flat, then CLI overrides.

    Precedence (low to high): YAML values -> explicit CLI flags ->
    ``--cfg-options`` dotted overrides.
    """
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", type=str, required=True, help="YAML config path")
    parser.add_argument("--ckpt", type=str, default=None, help="checkpoint path")
    parser.add_argument(
        "--cfg-options",
        dest="cfg_options",
        nargs="+",
        action=_StoreDictKeyPair,
        metavar="KEY=VAL",
        default={},
        help="dotted-path config overrides, e.g. a.b.c=1",
    )
    for extra in extra_args or []:
        extra = dict(extra)
        names = extra.pop("names")
        parser.add_argument(*names, **extra)

    ns = parser.parse_args(argv)
    cfg = parse_yaml(ns.config)

    # apply dotted overrides to the (possibly nested) yaml dict
    for key, value in (ns.cfg_options or {}).items():
        set_dotted(cfg, key, value)

    merged = Config()
    for key, value in cfg.items():
        setattr(merged, key, value)
    # CLI flags (config/ckpt/...) sit on top of the yaml namespace
    for key, value in vars(ns).items():
        if key == "cfg_options":
            continue
        if value is not None or not hasattr(merged, key):
            setattr(merged, key, value)
    return merged
