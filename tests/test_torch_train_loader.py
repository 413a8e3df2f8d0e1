"""The port's training loader against the JAX package's, on the CPU.

- Each train transform (``topdown_box_to_center_scale`` with its jitter,
  ``topdown_horizontal_random_flip``, ``topdown_halfbody_transform``,
  ``topdown_randomscale_rotation``, ``topdown_affine`` with its keypoints,
  ``topdown_generate_target`` standard, UDP and with joint weights) gives
  the JAX transform's output bit for bit from the same ``np.random`` state,
  and leaves that state where the JAX transform leaves it.
- The loader over tests/fixtures/tiny_coco.py's train split with
  hrnet_w32_tpu.yaml's ``train_transforms``, one worker and one seed gives
  the JAX loader's ``image``, ``target`` and ``target_weight`` bit for bit
  over 2 epochs (the shuffle changes per epoch); so does it with
  ``topdown_photometric_distortion`` (no recipe sets it) after the first
  transform, drawing from numpy's global stream as JAX's does.
- With 3 thread workers and with the process pool the records of each
  epoch come in the same order (the augmentations differ: the workers
  share or seed the random stream otherwise), ``len()`` drops the last
  partial batch, and a record that fails to load raises in the caller.
- Once the process pool's loader is closed, ``stop_worker_servers`` leaves
  none of its processes running: workers, forkserver, resource tracker.
- ``DevicePrefetcher`` on the CPU hands over the batches as tensors; what
  the port does not support raises, and ``device_pipeline: full``'s
  deferred flip and loader options are accepted.
"""
import copy
import os

import numpy as np
import pytest
import torch
import yaml

from mindpose_tpu.data import create_dataset as jax_create_dataset
from mindpose_tpu.data import create_pipeline as jax_create_pipeline
from mindpose_tpu.register import entrypoint as jax_entrypoint
from mindpose_tpu_torch.data import create_dataset, create_pipeline
from mindpose_tpu_torch.data.loader import DataLoader, DevicePrefetcher, stop_worker_servers
from mindpose_tpu_torch.register import entrypoint
from tests.fixtures import tiny_coco
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "configs", "hrnet", "hrnet_w32_tpu.yaml")) as f:
    RECIPE = yaml.safe_load(f)
SETTING = dict(RECIPE["dataset_setting"], joint_weights=list(np.linspace(0.5, 1.5, 17)))
TRAIN_TRANSFORMS = RECIPE["train_transforms"]
BATCH = 48  # the split's 192 records: 4 batches
SEED = 3
ORDER_COLUMNS = ["image_file", "bbox_ids", "target_weight"]

# (name, kwargs) of every train transform and setting the port copies
TRANSFORMS = [
    ("topdown_box_to_center_scale", {}),
    ("topdown_horizontal_random_flip", {"flip_prob": 0.5}),
    ("topdown_halfbody_transform", {"prob_half_body": 0.5, "scale_padding": 1.5}),
    ("topdown_randomscale_rotation", {"rot_factor": 40, "scale_factor": 0.5, "rot_prob": 0.6}),
    ("topdown_affine", {}),
    ("topdown_affine", {"use_udp": True}),
    ("topdown_generate_target", {"sigma": 2.0}),
    ("topdown_generate_target", {"sigma": 1.5, "use_udp": True}),
    ("topdown_generate_target", {"sigma": 2.0, "use_different_joint_weights": True}),
    ("topdown_photometric_distortion", {}),
    ("topdown_photometric_distortion", {"brightness_delta": 80.0, "hue_delta": 60.0}),
]


def _states(rng, n=40):
    """Records as they reach a train transform: a frame, a box and its
    center/scale/rotation, and keypoints (some invisible, some off the crop)."""
    w, h = SETTING["image_size"]
    for i in range(n):
        frame = rng.randint(0, 256, (int(rng.randint(100, 300)), int(rng.randint(100, 300)), 3),
                            dtype=np.uint8)
        xy = rng.uniform(-20, 320, (17, 2)) if i % 2 else rng.uniform(0, 1, (17, 2)) * [w, h]
        vis = (rng.uniform(0, 1, (17, 1)) < (0.9 if i % 3 else 0.3)).astype(np.float64)
        yield {
            "image": frame,
            "boxes": np.array([*rng.uniform(0, 100, 2), *rng.uniform(5, 200, 2)], np.float32),
            "keypoints": np.concatenate([xy, vis], axis=1).astype(np.float32),
            "center": rng.uniform(20, 200, 2).astype(np.float32),
            "scale": rng.uniform(0.2, 2.0, 2).astype(np.float32),
            "rotation": np.float32(rng.uniform(-80, 80) if i % 4 else 0.0),
        }


def _assert_same(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = got[k], want[k]
        assert type(g) is type(w), (what, k)
        if isinstance(w, (np.ndarray, np.generic)):
            assert g.dtype == w.dtype and np.shape(g) == np.shape(w), (what, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")
        else:
            assert g == w, (what, k)


@pytest.mark.parametrize("name, kwargs", TRANSFORMS,
                         ids=[f"{n} {k}" for n, k in TRANSFORMS])
def test_train_transform_bitwise(name, kwargs):
    port = entrypoint("transform", name)(is_train=True, config=SETTING, **kwargs)
    jax = jax_entrypoint("transform", name)(is_train=True, config=SETTING, **kwargs)
    for i, state in enumerate(_states(np.random.RandomState(5))):
        np.random.seed(100 + i)
        want = jax(copy.deepcopy(state))
        after = np.random.rand()
        np.random.seed(100 + i)
        got = port(copy.deepcopy(state))
        _assert_same(got, want, f"{name} record {i}")
        assert np.random.rand() == after  # the same draws, in the same number


@pytest.fixture(scope="module")
def train_split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tiny_coco"))
    return tiny_coco.write_split(os.path.join(root, "train"), tiny_coco.TRAIN_IMAGES,
                                 tiny_coco.TRAIN_SEED)


def _epochs(loader, n=2):
    np.random.seed(SEED)
    return [list(loader) for _ in range(n)]


def test_loader_equals_jax_bitwise_over_two_epochs(train_split):
    img_root, ann = train_split
    jax_ds = jax_create_dataset(img_root, ann, is_train=True, config=SETTING)
    port_ds = create_dataset(img_root, ann, is_train=True, config=SETTING)
    assert len(port_ds["dataset"]) == len(jax_ds["dataset"]) == 2 * tiny_coco.TRAIN_IMAGES
    kwargs = dict(method="topdown", batch_size=BATCH, is_train=True, config=SETTING,
                  num_workers=1, seed=SEED)
    want = _epochs(jax_create_pipeline(jax_ds, TRAIN_TRANSFORMS, **kwargs))
    got = _epochs(create_pipeline(port_ds, TRAIN_TRANSFORMS, **kwargs))
    assert [len(e) for e in got] == [len(e) for e in want] == [4, 4]
    for e, (got_epoch, want_epoch) in enumerate(zip(got, want)):
        for b, (g, w) in enumerate(zip(got_epoch, want_epoch)):
            assert list(g) == list(w) == ["image", "target", "target_weight"]
            for col in w:
                assert g[col].dtype == w[col].dtype and g[col].shape == w[col].shape
                np.testing.assert_array_equal(g[col], w[col], err_msg=f"epoch {e} batch {b} {col}")
    # the shuffle changes per epoch
    assert not np.array_equal(got[0][0]["target_weight"], got[1][0]["target_weight"])


def test_loader_with_photometric_distortion_equals_jax_bitwise(train_split):
    img_root, ann = train_split
    transforms = [TRAIN_TRANSFORMS[0], "topdown_photometric_distortion", *TRAIN_TRANSFORMS[1:]]
    kwargs = dict(method="topdown", batch_size=BATCH, is_train=True, config=SETTING,
                  num_workers=1, seed=SEED)
    want = _epochs(jax_create_pipeline(
        jax_create_dataset(img_root, ann, is_train=True, config=SETTING), transforms, **kwargs))
    got = _epochs(create_pipeline(
        create_dataset(img_root, ann, is_train=True, config=SETTING), transforms, **kwargs))
    plain = _epochs(create_pipeline(
        create_dataset(img_root, ann, is_train=True, config=SETTING), TRAIN_TRANSFORMS, **kwargs),
        n=1)
    assert [len(e) for e in got] == [len(e) for e in want] == [4, 4]
    for e, (got_epoch, want_epoch) in enumerate(zip(got, want)):
        for b, (g, w) in enumerate(zip(got_epoch, want_epoch)):
            assert list(g) == list(w) == ["image", "target", "target_weight"]
            for col in w:
                assert g[col].dtype == w[col].dtype and g[col].shape == w[col].shape
                np.testing.assert_array_equal(g[col], w[col], err_msg=f"epoch {e} batch {b} {col}")
    assert not np.array_equal(got[0][0]["image"], plain[0][0]["image"])  # the jitter acted


def _order(loader):
    """Each epoch's records as (image_file, bbox_id), in the order they came."""
    epochs = []
    for _ in range(2):
        epochs.append([(str(f), int(i)) for b in loader
                       for f, i in zip(b["image_file"], b["bbox_ids"])])
    return epochs


@pytest.mark.parametrize("workers, mode", [(3, "thread"), (3, "process")])
def test_more_workers_give_the_same_records_per_epoch(train_split, workers, mode):
    img_root, ann = train_split
    transforms = [entrypoint("transform", n if isinstance(n, str) else next(iter(n)))(
        is_train=True, config=SETTING, **({} if isinstance(n, str) else next(iter(n.values()))))
        for n in TRAIN_TRANSFORMS]
    ds = create_dataset(img_root, ann, is_train=True, config=SETTING)["dataset"]
    jax_ds = jax_create_dataset(img_root, ann, is_train=True, config=SETTING)
    batch = 50  # 192 records: 3 batches, 42 dropped
    jax_loader = jax_create_pipeline(jax_ds, TRAIN_TRANSFORMS, batch_size=batch, is_train=True,
                                     config=SETTING, num_workers=1, seed=SEED,
                                     final_columns=ORDER_COLUMNS)
    loader = DataLoader(ds, transforms, ORDER_COLUMNS, batch_size=batch, is_train=True,
                        num_workers=workers, seed=SEED, worker_mode=mode)
    try:
        assert len(loader) == len(jax_loader) == 3
        got, want = _order(loader), _order(jax_loader)
        assert got == want
        assert [len(e) for e in got] == [150, 150] and got[0] != got[1]
        assert (mode == "process") == (loader._pool is not None)
        assert len(DataLoader(ds, transforms, ORDER_COLUMNS, batch_size=batch,
                              is_train=True, drop_remainder=False)) == 4
    finally:
        loader.close()


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_a_worker_exception_reaches_the_caller(tmp_path, mode):
    img_root, ann = tiny_coco.write_split(str(tmp_path), 6, 5)
    ds = create_dataset(img_root, ann, is_train=True, config=SETTING)["dataset"]
    os.remove(ds[3]["image_file"])
    loader = DataLoader(ds, [], ["image"], batch_size=4, is_train=True, num_workers=2,
                        worker_mode=mode)
    try:
        with pytest.raises(FileNotFoundError, match="cannot read image"):
            list(loader)
    finally:
        loader.close()


def test_no_process_outlives_the_closed_pool(tmp_path):
    from multiprocessing import forkserver, resource_tracker

    img_root, ann = tiny_coco.write_split(str(tmp_path), 6, 5)
    ds = create_dataset(img_root, ann, is_train=True, config=SETTING)["dataset"]
    loader = DataLoader(ds, [], ["image"], batch_size=4, is_train=True, num_workers=2,
                        worker_mode="process")
    try:
        assert sum(len(b["image"]) for b in loader) == 4 * len(loader)
        pids = [p.pid for p in loader._pool._pool]
        pids += [forkserver._forkserver._forkserver_pid, resource_tracker._resource_tracker._pid]
    finally:
        loader.close()
    del loader
    stop_worker_servers()
    assert len(pids) == 4 and all(isinstance(p, int) for p in pids)
    assert [p for p in pids if os.path.exists(f"/proc/{p}")] == []


def test_the_pool_s_workers_read_their_state_from_a_file(tmp_path):
    """The pool's initializer gets a file's path (a few bytes down the
    forkserver's pipe, whatever the dataset's size); the workers' batches are
    the threads' records, and ``close`` removes the file."""
    import pickle

    img_root, ann = tiny_coco.write_split(str(tmp_path), 6, 5)
    ds = create_dataset(img_root, ann, is_train=True, config=SETTING)["dataset"]
    loader = DataLoader(ds, [], ["image", "image_file"], batch_size=4, is_train=True,
                        num_workers=2, worker_mode="process", seed=SEED)
    threads = DataLoader(ds, [], ["image", "image_file"], batch_size=4, is_train=True,
                         num_workers=2, seed=SEED)
    try:
        got = list(loader)
        path = loader._state_path
        assert os.path.isfile(path) and len(pickle.dumps(loader._pool._initargs)) < 1024
        with open(path, "rb") as f:
            assert len(pickle.load(f)[0]) == len(ds) == 12
    finally:
        loader.close()
    del loader
    stop_worker_servers()
    assert not os.path.exists(path)
    want = list(threads)
    assert [list(b["image_file"]) for b in got] == [list(b["image_file"]) for b in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])


def test_device_prefetcher_on_the_cpu_hands_over_tensors(train_split):
    img_root, ann = train_split
    ds = create_dataset(img_root, ann, is_train=True, config=SETTING)
    kwargs = dict(batch_size=BATCH, is_train=True, config=SETTING, num_workers=1, seed=SEED)
    want = _epochs(create_pipeline(ds, TRAIN_TRANSFORMS, **kwargs), 1)[0]
    columns = ["image", "target", "target_weight"]
    prefetcher = DevicePrefetcher(create_pipeline(ds, TRAIN_TRANSFORMS, **kwargs), columns, "cpu")
    assert len(prefetcher) == len(want)
    np.random.seed(SEED)
    got = list(prefetcher)
    for g, w in zip(got, want):
        for t, col in zip(g, columns):
            assert isinstance(t, torch.Tensor)
            np.testing.assert_array_equal(t.numpy(), w[col])
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher(want, columns, "cpu", depth=0)


def test_refusals(train_split):
    img_root, ann = train_split
    ds = create_dataset(img_root, ann, is_train=True, config=SETTING)["dataset"]
    # sharding is ported (tests/test_torch_ddp.py holds the shards to JAX's): a
    # rank outside the world still raises, and a rank's shard is accepted
    with pytest.raises(ValueError, match="rank_id"):
        DataLoader(ds, [], ["image"], device_num=2, rank_id=2)
    shard = create_pipeline(
        create_dataset(img_root, ann, is_train=True, device_num=4, rank_id=0, config=SETTING),
        TRAIN_TRANSFORMS, is_train=True, config=SETTING)
    assert shard.num_samples == len(range(0, len(ds), 4))
    with pytest.raises(ValueError, match="worker_mode"):
        DataLoader(ds, [], ["image"], worker_mode="fiber")
    with pytest.raises(ValueError, match="joint_weights"):
        entrypoint("transform", "topdown_generate_target")(
            is_train=True, config=RECIPE["dataset_setting"], use_different_joint_weights=True)
    # device_pipeline: full's flip and loader options are ported: accepted and
    # passed to the loader (tests/test_torch_frame_loader.py holds them to JAX's)
    flip = entrypoint("transform", "topdown_horizontal_random_flip")(
        is_train=True, config=SETTING, defer_to_warp=True)
    assert flip.defer_to_warp
    for kwargs in ({"image_bucket": 64}, {"decode_cache_mb": 64}, {"frame_grouped_shuffle": True},
                   {"patch_grouped_batching": True}):
        loader = create_pipeline({"dataset": ds}, TRAIN_TRANSFORMS, **dict(
            {"is_train": True, "config": SETTING}, **kwargs))
        assert loader.image_bucket == kwargs.get("image_bucket")
        assert (loader.decode_cache is not None) == ("decode_cache_mb" in kwargs)
        assert (loader._frame_groups is not None) == ("frame_grouped_shuffle" in kwargs)
        assert loader.patch_grouped_batching == kwargs.get("patch_grouped_batching", False)
    # bottom-up training is ported: the same call builds a train loader, whose
    # batch size the bottom-up evaluation's batch rule leaves alone
    loader = create_pipeline({"dataset": ds}, TRAIN_TRANSFORMS, **dict(
        {"is_train": True, "config": SETTING}, method="bottomup", batch_size=BATCH))
    assert isinstance(loader, DataLoader) and loader.is_train and loader.batch_size == BATCH
    assert loader.final_columns == ["image", "target", "mask", "tag_ind"]
