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
the records are the JAX loader's. The workers read the records and
transforms from a file the loader pickles them to, as the forkserver's
child reads its arguments only after it imports the main module: sent as
arguments, a large dataset would start the workers one after another.
``DataLoader.close`` ends the pool's workers and removes that file;
``stop_worker_servers`` ends the forkserver and the resource
tracker that multiprocessing starts beside them, which would otherwise
outlive the program for a while after it exits.

The options of ``device_pipeline: full`` are the JAX loader's, copied:
``image_bucket`` zero-pads a batch's images to the next multiple of the
bucket (:294); ``decode_cache_mb`` keeps decoded frames in a byte-budgeted
LRU shared by the threads, one per process of the pool
(``DecodedFrameCache``, :43-133), read-only, with concurrent decodes of one
frame coalesced; ``frame_grouped_shuffle`` shuffles frames and keeps each
frame's records together (:326); ``patch_grouped_batching`` batches
records of one bucket shape together (:400-505). With one worker the
indices, the batches and their bytes are the JAX loader's.

Sharding (:213-253): with ``device_num``/``rank_id`` a rank keeps the
records ``rank_id::device_num`` of the dataset, and everything else runs
on its own shard: the frame groups of ``frame_grouped_shuffle`` are built
from its records, the epoch's ``RandomState(seed + epoch)`` shuffles them,
and ``drop_remainder`` and ``patch_grouped_batching`` apply to its batches.
At one worker each rank's batches are the JAX loader's at the same
``device_num``/``rank_id``.

``DevicePrefetcher`` (:507) serves the train entry's ``device_prefetch: N``:
on a CUDA device a thread copies each batch from pinned host memory on a
side stream, ``N`` batches ahead of the step; on the CPU it hands the
batches over as tensors.
"""
import os
import queue
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["DataLoader", "DecodedFrameCache", "DevicePrefetcher", "stop_worker_servers"]

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


class DecodedFrameCache:
    """Byte-budgeted LRU of decoded RGB frames, shared by the loader's threads.

    Top-down training decodes a frame once per person on it, every epoch.
    The cache keeps each frame once, read-only, so a transform that writes
    into its input fails instead of changing another record's frame; a
    frame larger than the whole budget is returned and not kept.
    ``get_or_decode`` coalesces concurrent decodes of one frame: one thread
    decodes, the others wait for it (and decode themselves if it failed).
    """

    def __init__(self, budget_mb: float) -> None:
        self._budget = int(budget_mb * 1024 * 1024)
        self._lock = threading.Lock()
        self._frames: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._inflight: Dict[str, threading.Event] = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, path: str) -> Optional[np.ndarray]:
        with self._lock:
            arr = self._frames.get(path)
            if arr is None:
                self.misses += 1
            else:
                self._frames.move_to_end(path)
                self.hits += 1
            return arr

    def put(self, path: str, arr: np.ndarray) -> np.ndarray:
        arr.setflags(write=False)
        if arr.nbytes > self._budget:
            return arr
        with self._lock:
            if path not in self._frames:
                while self._bytes + arr.nbytes > self._budget and self._frames:
                    _, old = self._frames.popitem(last=False)
                    self._bytes -= old.nbytes
                self._frames[path] = arr
                self._bytes += arr.nbytes
        return arr

    def get_or_decode(self, path: str, decode_fn: Callable[[], np.ndarray]) -> np.ndarray:
        """The cached frame, or ``decode_fn()``'s, decoded by one thread at a time."""
        arr = self.get(path)
        if arr is not None:
            return arr
        with self._lock:
            arr = self._frames.get(path)
            if arr is not None:
                self.hits += 1
                return arr
            ev = self._inflight.get(path)
            owner = ev is None
            if owner:
                ev = threading.Event()
                self._inflight[path] = ev
        if owner:
            try:
                arr = decode_fn()
                arr = self.put(path, arr)
            finally:
                with self._lock:
                    self._inflight.pop(path, None)
                ev.set()
            return arr
        ev.wait()
        arr = self.get(path)
        return arr if arr is not None else decode_fn()


def _decode_image(state: Dict[str, Any],
                  cache: Optional[DecodedFrameCache] = None) -> Dict[str, Any]:
    """Read + decode the record's image file into an RGB uint8 HWC array."""
    path = state["image_file"]

    def read() -> np.ndarray:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"cannot read image: {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    state["image"] = read() if cache is None else cache.get_or_decode(path, read)
    return state


def _make_record(state: Dict[str, Any], transforms, normalize: bool, mean, std,
                 cache: Optional[DecodedFrameCache] = None):
    state = _decode_image(state, cache)
    for t in transforms:
        state = t(state)
    if normalize:
        state["image"] = (state["image"].astype(np.float32) - mean) / std
    return state


# --- the process pool's workers: the dataset and transforms are read once,
# by the pool's initializer, from the loader's state file
_WORKER_STATE: Dict[str, Any] = {}


def _process_worker_init(state_path: str) -> None:
    """A pool worker's start: its records, transforms and settings from the
    file the loader pickled them to (a few bytes of arguments, so that the
    forkserver's pipe never blocks the start of the next worker)."""
    import pickle

    from .transform.topdown_transform import _cv2

    with open(state_path, "rb") as f:
        dataset, transforms, normalize, mean, std, seed, decode_cache_mb = pickle.load(f)
    _WORKER_STATE.update(dataset=dataset, transforms=transforms, normalize=normalize,
                         mean=mean, std=std,
                         cache=DecodedFrameCache(decode_cache_mb) if decode_cache_mb else None)
    np.random.seed((seed + os.getpid()) % (2**31))
    # the JAX worker inherits the transforms module's 2 threads, then sets 1
    _cv2().setNumThreads(1)


def _process_worker_run(idx: int) -> Dict[str, Any]:
    w = _WORKER_STATE
    return _make_record(w["dataset"][int(idx)], w["transforms"], w["normalize"], w["mean"],
                        w["std"], w["cache"])


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
        image_bucket: Optional[int] = None,
        decode_cache_mb: float = 0,
        frame_grouped_shuffle: bool = False,
        patch_grouped_batching: bool = False,
    ) -> None:
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        device_num, rank_id = device_num or 1, rank_id or 0
        if not 0 <= rank_id < device_num:
            raise ValueError(f"rank_id must be in [0, device_num={device_num}), got {rank_id}")
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
        self.image_bucket = image_bucket
        self.patch_grouped_batching = patch_grouped_batching
        self.decode_cache_mb = decode_cache_mb
        self.decode_cache = DecodedFrameCache(decode_cache_mb) if decode_cache_mb else None
        self.epoch = 0
        self.device_num, self.rank_id = device_num, rank_id
        self._indices = np.arange(len(dataset))[rank_id::device_num]  # this rank's shard
        self._pool = None  # the process pool, made at the first process-mode pass
        self._state_path = None  # the file the pool's workers read their state from
        # frame-grouped shuffling: each frame's records of the shard, in dataset order
        self._frame_groups: Optional[List[np.ndarray]] = None
        if frame_grouped_shuffle:
            records = getattr(dataset, "_dataset", None)
            groups: Dict[Any, List[int]] = {}
            for i in self._indices.tolist():
                key = records[i].get("image_file", i) if records is not None else i
                groups.setdefault(key, []).append(i)
            self._frame_groups = [np.asarray(v) for v in groups.values()]

    def __len__(self) -> int:
        n = len(self._indices)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _process_one(self, idx: int) -> Dict[str, Any]:
        return _make_record(self.dataset[int(idx)], self.transforms, self.normalize, self.mean,
                            self.std, self.decode_cache)

    def _collate(self, states: List[Dict[str, Any]]) -> Dict[str, Any]:
        batch: Dict[str, Any] = {}
        for col in self.final_columns:
            vals = [s[col] for s in states]
            if isinstance(vals[0], str):
                batch[col] = np.array(vals, dtype=object)
            elif col == "image" and self.image_bucket:
                batch[col] = self._pad_to_bucket([np.asarray(v) for v in vals])
            else:
                batch[col] = np.stack([np.asarray(v) for v in vals])
        return batch

    def _pad_to_bucket(self, images: List[np.ndarray]) -> np.ndarray:
        """The images zero-padded to the batch's largest, rounded up to the bucket."""
        b = self.image_bucket
        bh = -(-max(im.shape[0] for im in images) // b) * b
        bw = -(-max(im.shape[1] for im in images) // b) * b
        out = np.zeros((len(images), bh, bw) + images[0].shape[2:], images[0].dtype)
        for i, im in enumerate(images):
            out[i, :im.shape[0], :im.shape[1]] = im
        return out

    def _process_map(self):
        """The pool's ``map`` in process mode with more than one worker, else None."""
        if self.worker_mode != "process" or self.num_workers == 1:
            return None
        if self._pool is None:
            import multiprocessing as mp
            import pickle
            import tempfile

            ctx = mp.get_context("forkserver")
            ctx.set_forkserver_preload(["mindpose_tpu_torch.data"])
            # Each worker's arguments go down a pipe that the forkserver's
            # child reads only after it has imported the main module, so
            # arguments larger than the pipe would start the workers one
            # after another; the state goes through a file instead
            fd, self._state_path = tempfile.mkstemp(prefix="mindpose-loader-", suffix=".pkl")
            with os.fdopen(fd, "wb") as f:
                pickle.dump((self.dataset, self.transforms, self.normalize, self.mean, self.std,
                             self.seed, self.decode_cache_mb), f,
                            protocol=pickle.HIGHEST_PROTOCOL)
            self._pool = ctx.Pool(processes=self.num_workers, initializer=_process_worker_init,
                                  initargs=(self._state_path,))
        return self._pool.map

    def close(self) -> None:
        """Stop the process pool, if there is one, and remove its state file."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
        self._remove_state()

    def _remove_state(self) -> None:
        path, self._state_path = getattr(self, "_state_path", None), None
        if path is not None and os.path.exists(path):
            os.unlink(path)

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.terminate()
        self._remove_state()

    @property
    def num_samples(self) -> int:
        """The records of this rank's shard."""
        return len(self._indices)

    def _epoch_indices(self) -> np.ndarray:
        idx = self._indices.copy()
        if self.is_train:
            rng = np.random.RandomState(self.seed + self.epoch)
            if self._frame_groups is not None:
                parts = []
                for g in rng.permutation(len(self._frame_groups)):
                    grp = self._frame_groups[g].copy()
                    rng.shuffle(grp)
                    parts.append(grp)
                return np.concatenate(parts)
            rng.shuffle(idx)
        return idx

    def _batch_states(self, indices: np.ndarray,
                      run: Callable[[np.ndarray], List[Dict[str, Any]]]
                      ) -> Iterator[List[Dict[str, Any]]]:
        """The epoch's batches as lists of records, ``run`` making the records
        of a list of indices."""
        if self.patch_grouped_batching and self.image_bucket:
            yield from self._patch_grouped(indices, run)
            return
        for i in range(len(self)):
            yield run(indices[i * self.batch_size:(i + 1) * self.batch_size])

    def _patch_grouped(self, indices: np.ndarray,
                       run: Callable[[np.ndarray], List[Dict[str, Any]]]
                       ) -> Iterator[List[Dict[str, Any]]]:
        """Batches of records whose images round up to one bucket shape.

        The records are made in windows of 4 batches, in the epoch's order,
        and held by their bucket shape; a bucket gives a batch as soon as it
        holds one. Past 8 batches held, the holder is drained as batches of
        size-sorted records and the rest held again; the epoch's end drains
        it the same way, and a last partial batch follows ``drop_remainder``.
        Every record comes once per epoch.
        """
        b, bs = self.image_bucket, self.batch_size
        buckets: Dict[tuple, list] = {}

        def bucket_key(state) -> tuple:
            h, w = np.asarray(state["image"]).shape[:2]
            return (-(-h // b) * b, -(-w // b) * b)

        def drain_sorted(final: bool) -> Iterator[List[Dict[str, Any]]]:
            rest = sorted((s for v in buckets.values() for s in v),
                          key=lambda s: (s["image"].shape[0], s["image"].shape[1]))
            buckets.clear()
            while len(rest) >= bs:
                yield rest[:bs]
                rest = rest[bs:]
            if final:
                if rest and not self.drop_remainder:
                    yield rest
                return
            for s in rest:
                buckets.setdefault(bucket_key(s), []).append(s)

        window = bs * 4
        for start in range(0, len(indices), window):
            for s in run(indices[start:start + window]):
                buckets.setdefault(bucket_key(s), []).append(s)
            for k in list(buckets):
                while len(buckets[k]) >= bs:
                    batch = buckets[k][:bs]
                    del buckets[k][:bs]
                    yield batch
            if sum(len(v) for v in buckets.values()) > bs * 8:
                yield from drain_sorted(final=False)
        if any(buckets.values()):
            yield from drain_sorted(final=True)

    def __iter__(self):
        indices = self._epoch_indices()
        self.epoch += 1
        out_q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_BATCHES)
        stop = threading.Event()
        process_map = self._process_map()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                    def run(idx: np.ndarray) -> List[Dict[str, Any]]:
                        if process_map is not None:
                            return process_map(_process_worker_run, [int(i) for i in idx])
                        return list(ex.map(self._process_one, idx))

                    for states in self._batch_states(indices, run):
                        if stop.is_set():
                            return
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
