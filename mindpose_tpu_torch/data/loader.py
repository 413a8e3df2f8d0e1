"""Host input pipeline: decode, transform, normalize and batch; and the
transfer of batches to the device.

Counterpart of ``mindpose_tpu/data/loader.py``: each record is decoded with
``cv2.imread`` then BGR -> RGB (:162-176), run through the transforms,
normalized with mean*255 and std*255 (:271-280), and the final columns are
stacked (:282-292). On train each epoch visits the records in the order of
``RandomState(seed + epoch)`` (:326-339) and drops the last partial batch
(``drop_remainder``); on val they come in dataset order, and the last batch
holds what is left. The records of a batch are made by ``num_workers``
threads (cv2 releases the interpreter lock), or with ``worker_mode=
"process"`` by a pool of processes, each seeding ``np.random`` with
``seed + pid`` (:135-159, :306-324). A producer thread keeps up to
``PREFETCH_BATCHES`` batches ready (:353-398), so batch i+1 loads while the
caller runs batch i.

The pool's processes come from a ``forkserver``, where the JAX loader
forks its own process: a fork taken after CUDA is initialised, or while the
producer thread holds a lock, can deadlock. The seeding and the order of
the records are the JAX loader's. ``DataLoader.close`` ends the pool's
workers; ``stop_worker_servers`` ends the forkserver and the resource
tracker that multiprocessing starts beside them, which would otherwise
outlive the program for a while after it exits.

Sharding (``device_num``/``rank_id`` other than 1/0) waits for DDP, and
shuffling by frame, bucketing and the decoded-frame cache for a slice that
uses them; ``data_factory`` refuses them.

``DevicePrefetcher`` (:507) serves the train entry's ``device_prefetch: N``:
on a CUDA device a thread copies each batch from pinned host memory on a
side stream, ``N`` batches ahead of the step; on the CPU it hands the
batches over as tensors.
"""
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["DataLoader", "DevicePrefetcher", "stop_worker_servers"]

PREFETCH_BATCHES = 2
WORKER_MODES = ("thread", "process")


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


def _consume(out_q: "queue.Queue", stop: threading.Event):
    """Yield the producer's items until its end marker; raise what it raised."""
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


def _decode_image(state: Dict[str, Any]) -> Dict[str, Any]:
    """Read + decode the record's image file into an RGB uint8 HWC array."""
    import cv2

    path = state["image_file"]
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    state["image"] = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return state


def _make_record(state: Dict[str, Any], transforms, normalize: bool, mean, std):
    state = _decode_image(state)
    for t in transforms:
        state = t(state)
    if normalize:
        state["image"] = (state["image"].astype(np.float32) - mean) / std
    return state


# --- the process pool's workers: the dataset and transforms are sent once,
# by the pool's initializer
_WORKER_STATE: Dict[str, Any] = {}


def _process_worker_init(dataset, transforms, normalize, mean, std, seed):
    from .transform.topdown_transform import _cv2

    _WORKER_STATE.update(dataset=dataset, transforms=transforms, normalize=normalize,
                         mean=mean, std=std)
    np.random.seed((seed + os.getpid()) % (2**31))
    # the JAX worker inherits the transforms module's 2 threads, then sets 1
    _cv2().setNumThreads(1)


def _process_worker_run(idx: int) -> Dict[str, Any]:
    w = _WORKER_STATE
    return _make_record(w["dataset"][int(idx)], w["transforms"], w["normalize"], w["mean"],
                        w["std"])


def stop_worker_servers() -> None:
    """Stop the forkserver and the resource tracker of the process pools.

    Call it once every process-mode loader is closed and dropped: the
    garbage collection here finalizes the pools' semaphores, which the
    tracker must see unlinked before it stops. A later pool starts both
    again.
    """
    import gc
    from multiprocessing import forkserver, resource_tracker

    gc.collect()
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


class DataLoader:
    """Iterate batches of stacked numpy arrays over the dataset."""

    def __init__(
        self,
        dataset: Any,
        transforms: Sequence[Callable[[Dict[str, Any]], Dict[str, Any]]],
        final_columns: Sequence[str],
        batch_size: int = 1,
        is_train: bool = True,
        normalize: bool = True,
        normalize_mean: Sequence[float] = (0.485, 0.456, 0.406),
        normalize_std: Sequence[float] = (0.229, 0.224, 0.225),
        num_workers: int = 4,
        device_num: Optional[int] = None,
        rank_id: Optional[int] = None,
        drop_remainder: Optional[bool] = None,
        seed: int = 0,
        worker_mode: str = "thread",
    ) -> None:
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if (device_num or 1) != 1 or (rank_id or 0) != 0:
            raise NotImplementedError(
                f"sharding (device_num={device_num}, rank_id={rank_id}) comes with DDP "
                "(ROADMAP.md, Queue 1, DDP)")
        if worker_mode not in WORKER_MODES:
            raise ValueError(f"worker_mode must be one of {WORKER_MODES}, got {worker_mode!r}")
        self.dataset = dataset
        self.transforms = list(transforms)
        self.final_columns = list(final_columns)
        self.batch_size = batch_size
        self.is_train = is_train
        self.normalize = normalize
        self.mean = np.asarray(normalize_mean, dtype=np.float32) * 255.0
        self.std = np.asarray(normalize_std, dtype=np.float32) * 255.0
        self.num_workers = max(1, num_workers)
        self.drop_remainder = is_train if drop_remainder is None else drop_remainder
        self.seed = seed
        self.worker_mode = worker_mode
        self.epoch = 0
        self._pool = None  # the process pool, made at the first process-mode pass

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _process_one(self, idx: int) -> Dict[str, Any]:
        return _make_record(self.dataset[int(idx)], self.transforms, self.normalize, self.mean,
                            self.std)

    def _collate(self, states: List[Dict[str, Any]]) -> Dict[str, Any]:
        batch: Dict[str, Any] = {}
        for col in self.final_columns:
            vals = [s[col] for s in states]
            if isinstance(vals[0], str):
                batch[col] = np.array(vals, dtype=object)
            else:
                batch[col] = np.stack([np.asarray(v) for v in vals])
        return batch

    def _process_map(self):
        """The pool's ``map`` in process mode with more than one worker, else None."""
        if self.worker_mode != "process" or self.num_workers == 1:
            return None
        if self._pool is None:
            import multiprocessing as mp

            ctx = mp.get_context("forkserver")
            ctx.set_forkserver_preload(["mindpose_tpu_torch.data"])
            self._pool = ctx.Pool(
                processes=self.num_workers,
                initializer=_process_worker_init,
                initargs=(self.dataset, self.transforms, self.normalize, self.mean, self.std,
                          self.seed),
            )
        return self._pool.map

    def close(self) -> None:
        """Stop the process pool, if there is one."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.terminate()

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.is_train:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx

    def __iter__(self):
        indices = self._epoch_indices()
        self.epoch += 1
        batch_indices = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                         for i in range(len(self))]
        out_q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_BATCHES)
        stop = threading.Event()
        process_map = self._process_map()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                    for bidx in batch_indices:
                        if stop.is_set():
                            return
                        if process_map is not None:
                            states = process_map(_process_worker_run, [int(i) for i in bidx])
                        else:
                            states = list(ex.map(self._process_one, bidx))
                        if not _put_until_stopped(out_q, stop, self._collate(states)):
                            return
                _put_until_stopped(out_q, stop, None)
            except BaseException as e:  # surface worker errors to the consumer
                _put_until_stopped(out_q, stop, e)

        threading.Thread(target=producer, daemon=True, name="loader-prefetch").start()
        yield from _consume(out_q, stop)


class DevicePrefetcher:
    """The loader's batches as lists of tensors on ``device``, in ``columns`` order.

    On a CUDA device a daemon thread stays ``depth`` batches ahead: it pins
    each batch's arrays and copies them to the device on a side stream, so
    the transfer of batches i+1..i+depth overlaps the step on batch i; the
    consumer's stream waits for a batch's copy before it is handed over. On
    the CPU the batches are handed over as tensors, one at a time.
    """

    def __init__(self, loader, columns: Sequence[str], device, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.loader = loader
        self.columns = list(columns)
        self.device = torch.device(device)
        self.depth = depth

    def __len__(self) -> int:
        return len(self.loader)

    def _host(self, batch) -> List[torch.Tensor]:
        return [torch.from_numpy(np.ascontiguousarray(batch[c])) for c in self.columns]

    def __iter__(self):
        if self.device.type != "cuda":
            for batch in self.loader:
                yield self._host(batch)
            return
        stream = torch.cuda.Stream(self.device)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def producer():
            try:
                with torch.cuda.device(self.device):
                    for batch in self.loader:
                        if stop.is_set():
                            return
                        host = [t.pin_memory() for t in self._host(batch)]
                        with torch.cuda.stream(stream):
                            arrays = [t.to(self.device, non_blocking=True) for t in host]
                            ready = torch.cuda.Event()
                            ready.record(stream)
                        if not _put_until_stopped(out_q, stop, (arrays, ready)):
                            return
                _put_until_stopped(out_q, stop, None)
            except BaseException as e:  # surface transfer/loader errors
                _put_until_stopped(out_q, stop, e)

        threading.Thread(target=producer, daemon=True, name="device-prefetch").start()
        current = torch.cuda.current_stream(self.device)
        for arrays, ready in _consume(out_q, stop):
            current.wait_event(ready)
            for a in arrays:
                a.record_stream(current)  # made on the side stream, used on this one
            yield arrays
