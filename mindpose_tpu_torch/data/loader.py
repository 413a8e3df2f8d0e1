"""Host input pipeline for evaluation: decode, transform, normalize, batch.

The val side of ``mindpose_tpu/data/loader.py:DataLoader``, in one process:
each record is decoded with ``cv2.imread`` then BGR -> RGB (:162-176), run
through the transforms, normalized with mean*255 and std*255 (:271-280),
and the final columns are stacked (:282-292). Records come in dataset
order, and the last batch holds what is left. ``num_workers`` threads make
the records of a batch, as the JAX loader's default thread workers do (cv2
releases the interpreter lock), and a producer thread keeps up to
``PREFETCH_BATCHES`` batches ready, the JAX loader's default (:353-398), so
batch i+1 loads while the caller runs batch i. The process pool, shuffling, sharding, bucketing and
the decoded-frame cache come with the training loader.
"""
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Sequence

import numpy as np

__all__ = ["DataLoader"]

PREFETCH_BATCHES = 2


def _put_until_stopped(q: "queue.Queue", stop: threading.Event, item) -> bool:
    """Queue put that gives up once ``stop`` is set.

    A consumer abandoning iteration mid-epoch (early break, exception) sets
    ``stop`` with the queue possibly full; a plain blocking put would strand
    the producer thread forever.
    """
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _decode_image(state: Dict[str, Any]) -> Dict[str, Any]:
    """Read + decode the record's image file into an RGB uint8 HWC array."""
    import cv2

    path = state["image_file"]
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    state["image"] = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return state


class DataLoader:
    """Iterate val batches of stacked numpy arrays over the dataset, in order."""

    def __init__(
        self,
        dataset: Any,
        transforms: Sequence[Callable[[Dict[str, Any]], Dict[str, Any]]],
        final_columns: Sequence[str],
        batch_size: int = 1,
        normalize: bool = True,
        normalize_mean: Sequence[float] = (0.485, 0.456, 0.406),
        normalize_std: Sequence[float] = (0.229, 0.224, 0.225),
        num_workers: int = 4,
    ) -> None:
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.transforms = list(transforms)
        self.final_columns = list(final_columns)
        self.batch_size = batch_size
        self.normalize = normalize
        self.mean = np.asarray(normalize_mean, dtype=np.float32) * 255.0
        self.std = np.asarray(normalize_std, dtype=np.float32) * 255.0
        self.num_workers = max(1, num_workers)

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _process_one(self, idx: int) -> Dict[str, Any]:
        state = _decode_image(self.dataset[int(idx)])
        for t in self.transforms:
            state = t(state)
        if self.normalize:
            state["image"] = (
                state["image"].astype(np.float32) - self.mean
            ) / self.std
        return state

    def _collate(self, states: List[Dict[str, Any]]) -> Dict[str, Any]:
        batch: Dict[str, Any] = {}
        for col in self.final_columns:
            vals = [s[col] for s in states]
            if isinstance(vals[0], str):
                batch[col] = np.array(vals, dtype=object)
            else:
                batch[col] = np.stack([np.asarray(v) for v in vals])
        return batch

    def __iter__(self):
        n = len(self.dataset)
        out_q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_BATCHES)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                    for start in range(0, n, self.batch_size):
                        if stop.is_set():
                            return
                        indices = range(start, min(start + self.batch_size, n))
                        states = list(ex.map(self._process_one, indices))
                        if not _put_until_stopped(out_q, stop, self._collate(states)):
                            return
                _put_until_stopped(out_q, stop, None)
            except BaseException as e:  # surface worker errors to the consumer
                _put_until_stopped(out_q, stop, e)

        t = threading.Thread(target=producer, daemon=True, name="loader-prefetch")
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
