"""The port's loader options of ``device_pipeline: full`` against the JAX loader's, on the CPU.

``image_bucket``, ``decode_cache_mb`` (``DecodedFrameCache``),
``frame_grouped_shuffle`` and ``patch_grouped_batching`` are copies of the
JAX loader's (``mindpose_tpu/data/loader.py``). With one worker and one
seed the port's loader gives the JAX loader's indices, batch composition
and bytes over two epochs, in full mode (``to_matrix_transforms`` of a
recipe's random augmentations: uint8 source patches, warp matrices,
keypoints) and on the host path, and its cache counts the same hits and
misses. The rest mirrors tests/data/test_decode_cache.py,
test_frame_grouped_shuffle.py and test_patch_grouped_batching.py on the
port: the cache's eviction, read-only frames, coalesced decodes (also
under a stress of many threads), a decoder's failure; frame-grouped
coverage and adjacency; patch-grouped exactly-once batches padded to their
own bucket; and the cache in the process pool.
"""
import sys
import threading
import time

import numpy as np
import pytest

from mindpose_tpu.data import create_dataset as jax_create_dataset
from mindpose_tpu.data import create_pipeline as jax_create_pipeline
from mindpose_tpu.data import device_pipeline as jax_device_pipeline
from mindpose_tpu.data.loader import DataLoader as JaxDataLoader
from mindpose_tpu_torch.data import create_dataset, create_pipeline
from mindpose_tpu_torch.data import device_pipeline
from mindpose_tpu_torch.data.loader import DataLoader, DecodedFrameCache, _decode_image
from mindpose_tpu_torch.register import entrypoint
from tests.helpers import make_tiny_coco
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

SETTING = {
    "image_size": [64, 64],
    "heatmap_size": [16, 16],
    "pixel_std": 200.0,
    "scale_padding": 1.25,
    "det_bbox_thr": 0.0,
    "flip_pairs": [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14], [15, 16]],
    "upper_body_ids": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10],
}
# a recipe's random augmentations: the source patches' sizes vary
TRANSFORMS = [
    "topdown_box_to_center_scale",
    {"topdown_horizontal_random_flip": {"flip_prob": 0.5}},
    {"topdown_halfbody_transform": {"prob_half_body": 0.3}},
    {"topdown_randomscale_rotation": {"rot_factor": 40, "scale_factor": 0.5, "rot_prob": 0.8}},
    "topdown_affine",
    {"topdown_generate_target": {"sigma": 1.5}},
]
# deterministic transforms: the random ones draw from the global stream, so
# two loaders in one process pair their draws only from one seed
PLAIN_TRANSFORMS = ["topdown_box_to_center_scale", "topdown_affine",
                    {"topdown_generate_target": {"sigma": 2.0}}]
BUCKET = 32
SEED = 3
FULL_COLUMNS = device_pipeline.DEVICE_FULL_FINAL_COLUMNS + ["bbox_ids", "image_file"]


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """12 frames of 3 persons each (36 records)."""
    return make_tiny_coco(str(tmp_path_factory.mktemp("frames")), num_images=12,
                          people_per_img=3)


def _full_transforms(dp):
    transforms, _ = dp.strip_host_target_transform(TRANSFORMS)
    return dp.to_matrix_transforms(transforms)


def _loader(create_ds, create_pl, fixture, transforms, batch_size=8, workers=1, **options):
    img_root, ann = fixture
    ds = create_ds(img_root, ann, dataset_format="coco_topdown", is_train=True, config=SETTING)
    return create_pl(ds, transforms, method="topdown", batch_size=batch_size, is_train=True,
                     config=SETTING, seed=SEED, num_workers=workers, **options)


def _epochs(loader, n=2):
    np.random.seed(SEED)
    return [list(loader) for _ in range(n)]


def _assert_epochs_equal(got, want):
    assert [len(e) for e in got] == [len(e) for e in want]
    for e, (got_epoch, want_epoch) in enumerate(zip(got, want)):
        for b, (g, w) in enumerate(zip(got_epoch, want_epoch)):
            assert list(g) == list(w)
            for col in w:
                assert g[col].dtype == w[col].dtype and g[col].shape == w[col].shape, col
                np.testing.assert_array_equal(g[col], w[col], err_msg=f"epoch {e} batch {b} {col}")


FULL_OPTIONS = [
    {"image_bucket": BUCKET},
    {"image_bucket": BUCKET, "decode_cache_mb": 64},
    {"image_bucket": BUCKET, "decode_cache_mb": 64, "frame_grouped_shuffle": True},
    {"image_bucket": BUCKET, "patch_grouped_batching": True},
    {"image_bucket": 64, "decode_cache_mb": 64, "frame_grouped_shuffle": True,
     "patch_grouped_batching": True},
]


@pytest.mark.parametrize("options", FULL_OPTIONS, ids=lambda o: "-".join(sorted(o)))
def test_full_mode_loader_equals_jax_bitwise(frames, options):
    kwargs = dict(normalize=False, final_columns=FULL_COLUMNS, **options)
    jax_loader = _loader(jax_create_dataset, jax_create_pipeline, frames,
                         _full_transforms(jax_device_pipeline), **kwargs)
    loader = _loader(create_dataset, create_pipeline, frames,
                     _full_transforms(device_pipeline), **kwargs)
    want, got = _epochs(jax_loader), _epochs(loader)
    _assert_epochs_equal(got, want)
    assert len(got[0]) == 36 // 8
    for batch in got[0]:
        assert batch["image"].dtype == np.uint8
        assert batch["image"].shape[1] % options["image_bucket"] == 0
        assert batch["image"].shape[2] % options["image_bucket"] == 0
    if options.get("decode_cache_mb"):
        assert (loader.decode_cache.hits, loader.decode_cache.misses) == (
            jax_loader.decode_cache.hits, jax_loader.decode_cache.misses)
        # each frame decoded at most once in two epochs (an epoch drops 4 records)
        assert 0 < loader.decode_cache.misses <= 12 < loader.decode_cache.hits
    else:
        assert loader.decode_cache is None


@pytest.mark.parametrize("options", [{"decode_cache_mb": 64},
                                     {"decode_cache_mb": 64, "frame_grouped_shuffle": True},
                                     {"image_bucket": BUCKET}],
                         ids=lambda o: "-".join(sorted(o)))
def test_host_mode_loader_equals_jax_bitwise(frames, options):
    """The options on the host path: the cv2 crop and flip read cached frames."""
    jax_loader = _loader(jax_create_dataset, jax_create_pipeline, frames, TRANSFORMS, **options)
    loader = _loader(create_dataset, create_pipeline, frames, TRANSFORMS, **options)
    _assert_epochs_equal(_epochs(loader), _epochs(jax_loader))


def test_frame_grouped_indices_equal_jax_s(frames):
    ds = create_dataset(*frames, is_train=True, config=SETTING)["dataset"]
    jax_ds = jax_create_dataset(*frames, is_train=True, config=SETTING)["dataset"]
    port = DataLoader(ds, [], ["bbox_ids"], batch_size=4, frame_grouped_shuffle=True, seed=SEED)
    jax = JaxDataLoader(jax_ds, [], ["bbox_ids"], batch_size=4, frame_grouped_shuffle=True,
                        seed=SEED)
    for _ in range(3):
        np.testing.assert_array_equal(port._epoch_indices(), jax._epoch_indices())
        port.epoch += 1
        jax.epoch += 1


# --- tests/data/test_decode_cache.py on the port

def test_cached_epochs_bit_match_uncached(frames):
    plain = _loader(create_dataset, create_pipeline, frames, PLAIN_TRANSFORMS, batch_size=4)
    cached = _loader(create_dataset, create_pipeline, frames, PLAIN_TRANSFORMS, batch_size=4,
                     decode_cache_mb=256)
    _assert_epochs_equal(_epochs(cached), _epochs(plain))  # epoch 2 from the cache
    assert cached.decode_cache.hits > 0


def test_cache_hit_rate_with_shared_frames(tmp_path):
    """4 persons on each of 2 frames: the first epoch already hits 3 of 4."""
    fixture = make_tiny_coco(str(tmp_path), num_images=2, people_per_img=4)
    loader = _loader(create_dataset, create_pipeline, fixture, PLAIN_TRANSFORMS, batch_size=4,
                     decode_cache_mb=256)
    list(loader)
    cache = loader.decode_cache
    assert cache.misses == 2  # one decode per frame
    assert cache.hits == len(loader) * loader.batch_size - 2


def test_lru_eviction_respects_budget():
    cache = DecodedFrameCache(budget_mb=1)
    cache.put("a", np.zeros((512, 512, 3), np.uint8))  # 0.75 MB
    cache.put("b", np.zeros((400, 400, 3), np.uint8))  # 0.46 MB: evicts a
    assert cache.get("a") is None
    assert cache.get("b") is not None
    cache.put("c", np.zeros((100, 100, 3), np.uint8))  # fits beside b
    assert cache.get("b") is not None and cache.get("c") is not None
    # a frame larger than the whole budget is returned, read-only, and not kept
    big = cache.put("big", np.zeros((1024, 1024, 3), np.uint8))
    assert cache.get("big") is None
    assert big.flags.writeable is False


def test_cached_frames_are_read_only_and_the_host_flip_copies(frames):
    img_root, _ = frames
    cache = DecodedFrameCache(budget_mb=64)
    state = _decode_image({"image_file": f"{img_root}/000000000001.jpg"}, cache)
    frame = state["image"]
    with pytest.raises(ValueError):
        frame[0, 0, 0] = 255
    before = frame.copy()
    flip = entrypoint("transform", "topdown_horizontal_random_flip")(
        is_train=True, config=SETTING, flip_prob=1.0)
    out = flip({"image": frame, "keypoints": np.zeros((17, 3), np.float32),
                "center": np.array([50.0, 60.0], np.float32)})
    assert out["image"] is not frame and out["image"].flags.writeable
    np.testing.assert_array_equal(out["image"], before[:, ::-1])
    deferred = entrypoint("transform", "topdown_horizontal_random_flip")(
        is_train=True, config=SETTING, flip_prob=1.0, defer_to_warp=True)
    out = deferred({"image": frame, "keypoints": np.zeros((17, 3), np.float32),
                    "center": np.array([50.0, 60.0], np.float32)})
    assert out["image"] is frame and out["hflip"] is True  # the pixels left to the warp
    np.testing.assert_array_equal(frame, before)
    assert cache.get(f"{img_root}/000000000001.jpg") is frame


def test_get_or_decode_coalesces_concurrent_decodes():
    """8 threads asking for one frame at once: one decode."""
    cache = DecodedFrameCache(64)
    calls = []
    lock = threading.Lock()

    def slow_decode():
        with lock:
            calls.append(1)
        time.sleep(0.05)
        return np.zeros((8, 8, 3), np.uint8)

    results = [None] * 8

    def worker(i):
        results[i] = cache.get_or_decode("/img/frame.jpg", slow_decode)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    assert all(r is not None and r.shape == (8, 8, 3) for r in results)


def test_get_or_decode_waiters_survive_decoder_failure():
    cache = DecodedFrameCache(64)
    attempts = []

    def decode():
        attempts.append(1)
        if len(attempts) == 1:
            raise OSError("truncated jpeg")
        return np.ones((4, 4, 3), np.uint8)

    with pytest.raises(OSError):
        cache.get_or_decode("/img/bad.jpg", decode)
    # the in-flight slot was cleared: a retry decodes afresh
    assert cache.get_or_decode("/img/bad.jpg", decode).shape == (4, 4, 3)


def test_many_threads_decode_each_frame_once():
    """32 threads, 2,000 lookups over 20 frames, the interpreter switching
    threads every microsecond: each frame is decoded exactly once, and every
    lookup gets its own frame."""
    cache = DecodedFrameCache(64)
    decodes = {}
    lock = threading.Lock()
    errors = []

    def decode_for(path):
        def decode():
            with lock:
                decodes[path] = decodes.get(path, 0) + 1
            return np.full((4, 4, 3), int(path), np.uint8)
        return decode

    def worker(seed):
        rng = np.random.RandomState(seed)
        for _ in range(2000 // 32):
            path = str(rng.randint(20))
            if int(cache.get_or_decode(path, decode_for(path))[0, 0, 0]) != int(path):
                errors.append(path)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert sorted(decodes.values()) == [1] * len(decodes) and len(decodes) <= 20


def test_the_cache_serves_the_process_pool(frames):
    """Each worker of the pool keeps its own cache: the pool's batches are the threads'."""
    img_root, ann = frames
    ds = create_dataset(img_root, ann, is_train=False, config=SETTING,
                        use_gt_bbox_for_val=True)
    kwargs = dict(method="topdown", batch_size=8, is_train=False, config=SETTING,
                  decode_cache_mb=64, final_columns=["image", "bbox_ids"])
    want = [list(create_pipeline(ds, PLAIN_TRANSFORMS[:2], num_workers=1, **kwargs))]
    loader = create_pipeline(ds, PLAIN_TRANSFORMS[:2], num_workers=2, **kwargs)
    pool = DataLoader(loader.dataset, loader.transforms, loader.final_columns, batch_size=8,
                      is_train=False, num_workers=2, worker_mode="process", decode_cache_mb=64)
    try:
        _assert_epochs_equal([list(pool), list(pool)], want * 2)
        assert pool._pool is not None
    finally:
        pool.close()


# --- tests/data/test_frame_grouped_shuffle.py on the port

class _FakeDataset:
    """6 frames x 4 records."""

    def __init__(self, frames=6, per=4):
        self._dataset = [{"image_file": f"/img/{f:03d}.jpg", "rec": f * per + r}
                         for f in range(frames) for r in range(per)]

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, i):
        return dict(self._dataset[i])


def _grouped(**kw):
    return DataLoader(dataset=_FakeDataset(), transforms=[], final_columns=["rec"], batch_size=4,
                      is_train=True, normalize=False, frame_grouped_shuffle=True, **kw)


def test_frame_grouped_epochs_cover_every_record_once_with_frames_adjacent():
    loader = _grouped()
    ds = loader.dataset
    orders = []
    for _ in range(3):
        idx = loader._epoch_indices()
        loader.epoch += 1
        assert sorted(idx.tolist()) == list(range(24))
        files = [ds._dataset[i]["image_file"] for i in idx]
        runs = [f for j, f in enumerate(files) if j == 0 or f != files[j - 1]]
        assert len(runs) == 6, runs  # each frame's 4 records in one run
        orders.append(idx)
    assert not np.array_equal(orders[0], orders[1])


def test_frame_grouped_iteration_decodes_each_frame_once(tmp_path):
    import cv2

    ds = _FakeDataset()
    for rec in ds._dataset:
        path = str(tmp_path / rec["image_file"].rsplit("/", 1)[1])
        cv2.imwrite(path, np.zeros((8, 8, 3), np.uint8))
        rec["image_file"] = path
    loader = DataLoader(dataset=ds, transforms=[], final_columns=["rec"], batch_size=4,
                        is_train=True, normalize=False, frame_grouped_shuffle=True,
                        decode_cache_mb=64, num_workers=1)
    batches = list(loader)
    assert len(batches) == 6
    assert sorted(np.concatenate([b["rec"] for b in batches]).tolist()) == list(range(24))
    assert loader.decode_cache.misses == 6 and loader.decode_cache.hits == 18


# --- tests/data/test_patch_grouped_batching.py on the port

def _patch_loader(fixture, patch_grouped, batch_size=8, workers=2, seed=0):
    img_root, ann = fixture
    ds = create_dataset(img_root, ann, dataset_format="coco_topdown", is_train=True,
                        config=SETTING)
    return create_pipeline(ds, _full_transforms(device_pipeline), method="topdown",
                           batch_size=batch_size, is_train=True, normalize=False,
                           config=SETTING, seed=seed, num_workers=workers,
                           final_columns=device_pipeline.DEVICE_FULL_FINAL_COLUMNS + ["bbox_ids"],
                           image_bucket=BUCKET, patch_grouped_batching=patch_grouped)


def test_patch_grouped_exactly_once_and_bucket_shapes(tmp_path):
    fixture = make_tiny_coco(str(tmp_path), num_images=12, people_per_img=4)
    batches = list(_patch_loader(fixture, True))
    plain = list(_patch_loader(fixture, False))
    got = sorted(int(i) for b in batches for i in b["bbox_ids"])
    assert got == sorted(int(i) for b in plain for i in b["bbox_ids"]) and len(got) == 48
    for b in batches:
        h, w = b["image"].shape[1:3]
        assert h % BUCKET == 0 and w % BUCKET == 0
    assert len({b["image"].shape[1:3] for b in batches}) > 1
    assert sum(b["image"].nbytes for b in batches) < sum(b["image"].nbytes for b in plain)


def test_patch_grouped_deterministic_and_remainder(tmp_path):
    fixture = make_tiny_coco(str(tmp_path), num_images=10, people_per_img=3)  # 30 records
    np.random.seed(7)
    a = list(_patch_loader(fixture, True, workers=1, seed=3))
    np.random.seed(7)
    b = list(_patch_loader(fixture, True, workers=1, seed=3))
    assert [x["image"].shape for x in a] == [x["image"].shape for x in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["bbox_ids"], y["bbox_ids"])
    # drop_remainder on train: 3 batches of 8, the 6-record tail dropped
    assert len(a) == 3 and all(x["image"].shape[0] == 8 for x in a)
