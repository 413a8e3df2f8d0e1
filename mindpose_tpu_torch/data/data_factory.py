"""Dataset + pipeline factories.

Counterpart of ``mindpose_tpu/data/data_factory.py:21-138``, with the same
arguments: the top-down and bottom-up train and val pipelines (train:
shuffled per epoch from ``seed``, the last partial batch dropped), with the
JAX package's batch rule for bottom-up evaluation (:93-118), and the
loader options of ``device_pipeline: full`` (``image_bucket``,
``decode_cache_mb``, ``frame_grouped_shuffle``, ``patch_grouped_batching``)
and the rank's shard (``device_num``, ``rank_id``) passed through.
``hwc_to_chw`` is accepted and not read, as the JAX package's
``create_pipeline`` does not read it (batches stay NHWC). An argument the
port does not support (other methods) raises rather than being ignored.
"""
import logging
from typing import Any, Dict, List, Optional, Union

from ..register import entrypoint
from . import dataset as _datasets  # noqa: F401  (registers the datasets)
from .column_names import FINAL_COLUMN_MAP
from .loader import DataLoader
from .transform import topdown_transform as _transforms  # noqa: F401  (registers the transforms)

__all__ = ["create_dataset", "create_pipeline"]


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {item})")


def create_dataset(
    image_root: str,
    annotation_file: Optional[str] = None,
    dataset_format: str = "coco_topdown",
    is_train: bool = True,
    device_num: Optional[int] = None,
    rank_id: Optional[int] = None,
    num_workers: int = 1,
    config: Optional[Dict[str, Any]] = None,
    **kwargs: Any,
):
    """Instantiate the record dataset plus its loader context.

    Returns a dict bundle consumed by ``create_pipeline``, whose loader
    keeps the records ``rank_id::device_num``.
    """
    kwargs = {k: v for k, v in kwargs.items() if v is not None}
    dataset = entrypoint("dataset", dataset_format)(
        image_root, annotation_file, is_train=is_train, config=config, **kwargs
    )
    return {
        "dataset": dataset,
        "dataset_format": dataset_format,
        "is_train": is_train,
        "device_num": device_num,
        "rank_id": rank_id,
        "num_workers": num_workers,
    }


def create_pipeline(
    dataset: Union[Dict[str, Any], Any],
    transforms: List[Union[str, Dict[str, Any]]],
    method: str = "topdown",
    batch_size: int = 1,
    is_train: bool = True,
    normalize: bool = True,
    normalize_mean: List[float] = [0.485, 0.456, 0.406],
    normalize_std: List[float] = [0.229, 0.224, 0.225],
    hwc_to_chw: bool = False,
    num_workers: int = 1,
    config: Optional[Dict[str, Any]] = None,
    seed: int = 0,
    final_columns: Optional[List[str]] = None,
    image_bucket: Optional[int] = None,
    decode_cache_mb: float = 0,
    frame_grouped_shuffle: bool = False,
    patch_grouped_batching: bool = False,
) -> DataLoader:
    """Build the transform pipeline and return a batched DataLoader.

    Batches are NHWC numpy arrays (train targets HWK; bottom-up
    ``[S, Hmax, Wmax, K]`` per record), as the JAX loader gives them, whatever
    ``hwc_to_chw`` says; the inferencer and the train entry turn them to NCHW
    on the device. ``seed`` seeds the training shuffle; evaluation does not
    read it. ``final_columns`` overrides the method's projection (the device
    pipeline ships keypoints in place of targets).
    """
    if method not in FINAL_COLUMN_MAP:
        _refuse(f"method={method!r}", "Queue 1")
    bundle = dataset if isinstance(dataset, dict) else {"dataset": dataset, "num_workers": 1}
    if method == "bottomup" and not is_train and batch_size != 1:
        batch_size = _bottomup_val_batch(transforms, config, batch_size)
    transform_funcs = _convert_names_to_transform(transforms, is_train=is_train, config=config)
    return DataLoader(
        dataset=bundle["dataset"],
        transforms=transform_funcs,
        final_columns=final_columns or FINAL_COLUMN_MAP[method]["train" if is_train else "val"],
        batch_size=batch_size,
        is_train=is_train,
        normalize=normalize,
        normalize_mean=normalize_mean,
        normalize_std=normalize_std,
        num_workers=max(num_workers, bundle.get("num_workers", 1) or 1),
        device_num=bundle.get("device_num"),
        rank_id=bundle.get("rank_id"),
        seed=seed,
        image_bucket=image_bucket,
        decode_cache_mb=decode_cache_mb,
        frame_grouped_shuffle=frame_grouped_shuffle,
        patch_grouped_batching=patch_grouped_batching,
    )


def _bottomup_val_batch(transforms, config: Optional[Dict[str, Any]], batch_size: int) -> int:
    """The JAX package's rule: bottom-up images batch only where ``bottomup_pad``
    gives them one shape, that is with a square ``max_image_size`` (the pad
    swaps a non-square one's sides for portrait images); else batch 1."""
    names = [t if isinstance(t, str) else next(iter(t)) for t in transforms]
    max_size = (config or {}).get("max_image_size")
    square = bool(max_size) and max_size[0] == max_size[1]
    if "bottomup_pad" not in names:
        logging.info("Set batch_size = 1 for `bottomup` evaluation (no bottomup_pad "
                     "transform -> variable image sizes).")
        return 1
    if not square:
        logging.info("Set batch_size = 1 for `bottomup` evaluation (non-square "
                     "max_image_size %s pads portrait and landscape images to "
                     "different shapes).", max_size)
        return 1
    return batch_size


def _convert_names_to_transform(
    names_with_args: List[Union[str, Dict[str, Any]]],
    is_train: bool = True,
    config: Optional[Dict[str, Any]] = None,
):
    transforms = []
    for name_with_arg in names_with_args:
        if isinstance(name_with_arg, str):
            name, kwargs = name_with_arg, dict()
        else:
            name = list(name_with_arg.keys())[0]
            kwargs = list(name_with_arg.values())[0] or dict()
        transforms.append(
            entrypoint("transform", name)(is_train=is_train, config=config, **kwargs)
        )
    return transforms
