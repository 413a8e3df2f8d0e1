"""The train loader's batches against its worker count, in the port and in the
JAX package, on the CPU.

Both loaders make a batch's records on ``num_workers`` threads, and every
train augmentation draws from numpy's global stream. So the batches are a
function of the seed only at one worker; with more, each record takes its
draws in the order the threads reach the stream, which changes from run to
run. ``chip_smoke.py`` phase 23 (resnet50_rle_tpu.yaml, whose recipe sets 8
workers) once read its second epoch's loss above its first on unchanged
code for that reason; it trains at one worker.

- One worker: the port's loader gives the same batches (image, regression
  target, target weight) on two passes from one seed, and they are the JAX
  loader's bit for bit, over 2 epochs, with resnet50_rle_tpu.yaml's train
  transforms.
- Two workers: a transform that draws, waits at a barrier until the other
  thread's record has drawn too, then draws again, makes the two records'
  draws interleave. In the port's loader and in the JAX package's alike,
  the records and their order are one worker's, the draws over an epoch are
  one worker's, and every record holds other draws than one worker gives it.
- A second cause, at any worker count: the producer thread makes batches
  ahead of the consumer, and once an iteration is closed it still finishes
  the batch it is making. So an iteration left after its first batch (a
  check of one batch) draws from the stream after a later run has seeded
  it, in both loaders; ``chip_smoke.first_batch`` waits for the producer,
  and after it no producer is left and the batch is the pass's first.

Phase 25's full mode (hrnet_w32_tpu.yaml, ``patch_grouped_batching``) read
AP 0.0 to 0.22 after 30 steps at 8 threads, and 0.45-0.47 without that
option. That is not thread order: patch-grouped batching batches source
patches of one bucket shape, so each batch holds persons of one scale, in
both loaders (the last test).
"""
import os
import threading
import time

import numpy as np
import pytest
import yaml

from mindpose_tpu.data import create_dataset as jax_create_dataset
from mindpose_tpu.data import create_pipeline as jax_create_pipeline
from mindpose_tpu.data import device_pipeline as jax_device_pipeline
from mindpose_tpu.data.loader import DataLoader as JaxDataLoader
from mindpose_tpu_torch.data import create_dataset, create_pipeline, device_pipeline
from mindpose_tpu_torch.data.loader import DataLoader
from mindpose_tpu_torch.tools import make_synthetic_coco
from tests.fixtures import tiny_coco
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "configs", "rle", "resnet50_rle_tpu.yaml")) as f:
    RECIPE = yaml.safe_load(f)
SETTING = RECIPE["dataset_setting"]
SEED = 7
BATCH = 32  # the split's records: 6 batches
COLUMNS = ("image", "target", "target_weight")
DRAW_BATCH = 4  # two pairs of records on the two threads
BARRIER_TIMEOUT_S = 60
SCALE_FRAMES = 64  # chip_smoke's synthetic frames, 2 persons each: 8 batches
SCALE_BATCH = 16
SCALE_GROUPED_BELOW = 0.5  # measured 0.129 in both loaders
SCALE_MIXED_ABOVE = 0.8  # measured 0.945


@pytest.fixture(scope="module")
def train_split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tiny_coco"))
    return tiny_coco.write_split(os.path.join(root, "train"), tiny_coco.TRAIN_IMAGES,
                                 tiny_coco.TRAIN_SEED)


def _batches(loader, epochs=2):
    """``loader``'s batches over ``epochs``, the global stream seeded first
    (as the train entry seeds it)."""
    np.random.seed(SEED)
    return [batch for _ in range(epochs) for batch in loader]


def _port_loader(split, workers):
    ds = create_dataset(*split, is_train=True, config=SETTING)
    return create_pipeline(ds, RECIPE["train_transforms"], method="topdown", batch_size=BATCH,
                           is_train=True, config=SETTING, num_workers=workers, seed=SEED)


def test_one_worker_gives_the_same_batches_as_jax_on_every_pass(train_split):
    first = _batches(_port_loader(train_split, 1))
    again = _batches(_port_loader(train_split, 1))
    jax_ds = jax_create_dataset(*train_split, is_train=True, config=SETTING)
    want = _batches(jax_create_pipeline(jax_ds, RECIPE["train_transforms"], method="topdown",
                                        batch_size=BATCH, is_train=True, config=SETTING,
                                        num_workers=1, seed=SEED))
    assert len(first) == len(again) == len(want) == 2 * (2 * tiny_coco.TRAIN_IMAGES // BATCH)
    for got, other, expected in zip(first, again, want):
        assert sorted(got) == sorted(expected)
        for column in COLUMNS:
            assert got[column].dtype == expected[column].dtype
            np.testing.assert_array_equal(got[column], other[column])
            np.testing.assert_array_equal(got[column], expected[column])
    assert not np.array_equal(first[0]["image"], first[len(first) // 2]["image"])


class Draws:
    """A train transform that draws twice from numpy's global stream; with a
    barrier, it waits between the draws until as many records have drawn
    their first."""

    def __init__(self, barrier=None):
        self.barrier = barrier

    def __call__(self, state):
        first = np.random.rand()
        if self.barrier is not None:
            self.barrier.wait(timeout=BARRIER_TIMEOUT_S)
        state["draws"] = np.array([first, np.random.rand()])
        return state


def _draws(package, split, workers):
    """One epoch of ``package``'s loader with ``Draws`` on ``workers``
    threads: each record's file and box, and its draws."""
    if package == "port":
        dataset = create_dataset(*split, is_train=True, config=SETTING)["dataset"]
        loader_class = DataLoader
    else:
        dataset = jax_create_dataset(*split, is_train=True, config=SETTING)["dataset"]
        loader_class = JaxDataLoader
    barrier = threading.Barrier(workers) if workers > 1 else None
    loader = loader_class(dataset, [Draws(barrier)], ["image_file", "bbox_ids", "draws"],
                          batch_size=DRAW_BATCH, is_train=True, normalize=False,
                          num_workers=workers, seed=SEED)
    batches = _batches(loader, epochs=1)
    records = [(str(f), int(i)) for b in batches for f, i in zip(b["image_file"], b["bbox_ids"])]
    return records, np.concatenate([b["draws"] for b in batches])


@pytest.mark.parametrize("package", ["port", "jax"])
def test_threads_take_the_draws_in_the_order_they_reach_the_stream(train_split, package):
    records, one = _draws(package, train_split, 1)
    records_two, two = _draws(package, train_split, 2)
    assert records_two == records and len(set(records)) == len(records)
    # the same stream, drawn as often: the same values, handed out otherwise
    np.testing.assert_array_equal(np.sort(two, axis=None), np.sort(one, axis=None))
    differs = [not np.array_equal(a, b) for a, b in zip(two, one)]
    assert all(differs), f"{differs.count(False)} of {len(differs)} records kept their draws"


class Gated:
    """A train transform that draws once per record; past the first
    ``DRAW_BATCH`` records (one worker: in order) it first waits for
    ``gate``."""

    def __init__(self, gate):
        self.gate, self.calls = gate, 0

    def __call__(self, state):
        self.calls += 1
        if self.calls > DRAW_BATCH:
            self.gate.wait(timeout=BARRIER_TIMEOUT_S)
        state["draws"] = np.array([np.random.rand()])
        return state


def _loader(package, split, transforms):
    data = (create_dataset if package == "port" else jax_create_dataset)(
        *split, is_train=True, config=SETTING)["dataset"]
    return (DataLoader if package == "port" else JaxDataLoader)(
        data, transforms, ["bbox_ids", "draws"], batch_size=DRAW_BATCH, is_train=True,
        normalize=False, num_workers=1, seed=SEED)


def _producers():
    return [t for t in threading.enumerate() if t.name == "loader-prefetch" and t.is_alive()]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_closed_iteration_draws_until_its_batch_is_made(train_split, package):
    gate = threading.Event()
    loader = _loader(package, train_split, [Gated(gate)])
    np.random.seed(SEED)
    batches = iter(loader)
    next(batches)
    batches.close()  # the producer is making the second batch: it waits at the gate
    np.random.seed(SEED)  # a later run seeds the stream
    seeded = np.random.get_state()[1].copy()
    gate.set()
    for thread in _producers():
        thread.join(timeout=BARRIER_TIMEOUT_S)
    assert not _producers()
    assert not np.array_equal(np.random.get_state()[1], seeded)


def test_first_batch_waits_for_the_producer(train_split):
    import chip_smoke

    np.random.seed(SEED)
    want = next(iter(_loader("port", train_split, [Draws()])))
    for thread in _producers():  # that iteration's producer ends before the next seed
        thread.join(timeout=BARRIER_TIMEOUT_S)
    np.random.seed(SEED)
    got = chip_smoke.first_batch(_loader("port", train_split, [Draws()]))
    assert not _producers()
    seeded_after = np.random.get_state()[1].copy()
    time.sleep(0.2)
    np.testing.assert_array_equal(np.random.get_state()[1], seeded_after)
    for column in ("bbox_ids", "draws"):
        np.testing.assert_array_equal(got[column], want[column])


def _log_scale_spread(package, root, patch_grouped):
    """Full mode's batches (hrnet_w32_tpu.yaml's augmentations as warp
    matrices, ``image_bucket`` 64, one worker) over chip_smoke's synthetic
    frames: the mean of each batch's variance of log crop scale, over the
    variance of all of them."""
    with open(os.path.join(ROOT, "configs", "hrnet", "hrnet_w32_tpu.yaml")) as f:
        recipe = yaml.safe_load(f)
    dp = jax_device_pipeline if package == "jax" else device_pipeline
    create_ds, create_pl = ((jax_create_dataset, jax_create_pipeline) if package == "jax"
                            else (create_dataset, create_pipeline))
    transforms, _ = dp.strip_host_target_transform(recipe["train_transforms"])
    ds = create_ds(os.path.join(root, "images"), os.path.join(root, "annotations.json"),
                   is_train=True, config=recipe["dataset_setting"])
    loader = create_pl(ds, dp.to_matrix_transforms(transforms), method="topdown",
                       batch_size=SCALE_BATCH, is_train=True, normalize=False,
                       config=recipe["dataset_setting"], seed=SEED, num_workers=1,
                       final_columns=dp.DEVICE_FULL_FINAL_COLUMNS, image_bucket=64,
                       patch_grouped_batching=patch_grouped)
    np.random.seed(SEED)
    scales = [0.5 * np.log(np.abs(np.linalg.det(b["warp_mat"][:, :2, :2].astype(np.float64))))
              for b in loader]
    return np.mean([v.var() for v in scales]) / np.concatenate(scales).var()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_patch_grouped_batching_batches_persons_of_one_scale(tmp_path, package):
    root = str(tmp_path / "frames")
    make_synthetic_coco.generate_split(root, SCALE_FRAMES, seed=0, people_per_img=2,
                                       layout="person")
    grouped = _log_scale_spread(package, root, True)
    mixed = _log_scale_spread(package, root, False)
    print(f"{package}: within-batch variance of log crop scale over the whole, "
          f"patch-grouped {grouped:.3f}, not {mixed:.3f}")
    assert grouped < SCALE_GROUPED_BELOW < SCALE_MIXED_ABOVE < mixed
