"""The port's data and launch tools against the JAX package's, on the CPU.

- ``make_synthetic_coco`` and ``convert_mpii``, run as command lines,
  write the files their originals write, byte for byte;
- ``prepare_coco --dry-run`` prints the original's plan (nothing is
  downloaded); the port's rank is torchrun's ``RANK``, or 0;
- ``launch_pod``: two copies as two hosts (``PROCESS_ID`` 0 and 1,
  ``NUM_PROCESSES`` 2, a coordinator on localhost), each starting one CPU
  process through ``torchrun --nnodes 2``, train the fixtures' reduced HRNet
  on tiny_coco for one step over gloo; the preparation command runs once,
  on rank 0, behind the barrier, and both hosts finish. Without
  ``PROCESS_ID`` in a job of two hosts the launcher refuses to guess;
- ``version.__version__`` is the JAX package's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mindpose_tpu.version import __version__ as jax_version
from mindpose_tpu_torch.version import __version__
from mindpose_tpu_torch.tools import launch_pod, prepare_coco
from mindpose_tpu_torch.utils.checkpoint import load_checkpoint
from tests.fixtures import ddp_ranks, tiny_coco
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)
from tests.test_torch_train_entry import CONFIG_NAME, RECIPE, SEED, TRAIN_IMAGES, _overrides

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOSTS = 2
BATCH = 32  # per card: 64 records, 32 a host, 1 step
LAUNCH_TIMEOUT_S = 600
# launch_pod's main, its ranks running the train entry with the fixtures' net registered
POD_MAIN = ("import sys; from mindpose_tpu_torch.tools import launch_pod; "
            "launch_pod.TRAIN_ENTRY = 'tests.fixtures.pod_entry'; launch_pod.main(sys.argv[1:])")


def _run(argv, **kwargs):
    proc = subprocess.run([sys.executable, *argv], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, **kwargs)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_version_is_the_jax_package_s():
    assert __version__ == jax_version == "0.1.0"


@pytest.mark.parametrize("flags", [[], ["--people", "3", "--layout", "person"]])
def test_make_synthetic_coco_writes_the_original_s_files(tmp_path, flags):
    counts = ["--train-images", "3", "--val-images", "2"]
    _run([os.path.join(ROOT, "tools", "make_synthetic_coco.py"), "--out",
          str(tmp_path / "jax"), *counts, *flags])
    _run(["-m", "mindpose_tpu_torch.tools.make_synthetic_coco", "--out", str(tmp_path / "port"),
          *counts, *flags])
    want = _files(tmp_path / "jax")
    assert len(want) == 3 + 2 + 2  # the frames and one annotation file a split
    assert _files(tmp_path / "port") == want


@pytest.mark.parametrize("flags", [[], ["--no-center-shift"], ["--img-root", "IMAGES"]])
def test_convert_mpii_writes_the_original_s_file(tmp_path, flags):
    from tests.fixtures import mpii

    records = mpii.mpii_records(np.random.RandomState(2), num_images=3, people=2)
    with open(tmp_path / "mpii.json", "w") as f:
        json.dump(records, f)
    images = tmp_path / "images"
    images.mkdir()
    import cv2

    for r in records:
        cv2.imwrite(str(images / r["image"]), np.zeros((300, 400, 3), np.uint8))
    flags = [str(images) if f == "IMAGES" else f for f in flags]
    for label, tool in (("jax", [os.path.join(ROOT, "tools", "convert_mpii.py")]),
                        ("port", ["-m", "mindpose_tpu_torch.tools.convert_mpii"])):
        out = _run([*tool, "--input", str(tmp_path / "mpii.json"), "--output",
                    str(tmp_path / f"{label}.json"), *flags])
        assert "3 images, 6 annotations" in out
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


@pytest.mark.parametrize("flags", [[], ["--detection-results"]])
def test_prepare_coco_dry_run_prints_the_original_s_plan(tmp_path, flags):
    data_dir = tmp_path / "coco"
    (data_dir / "annotations").mkdir(parents=True)
    (data_dir / "annotations" / "person_keypoints_val2017.json").write_text("{}")
    argv = ["--data-dir", str(data_dir), "--dry-run", *flags]
    want = _run([os.path.join(ROOT, "tools", "prepare_coco.py"), *argv],
                env=dict(os.environ, JAX_PLATFORMS="cpu"))
    got = _run(["-m", "mindpose_tpu_torch.tools.prepare_coco", *argv])
    assert got == want
    assert "[have] annotations/person_keypoints_val2017.json" in got
    assert sorted(os.listdir(data_dir)) == ["annotations"]  # nothing written


def test_prepare_coco_rank_is_torchrun_s(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    assert prepare_coco._rank() == 0
    monkeypatch.setenv("RANK", "3")
    assert prepare_coco._rank() == 3


def test_torchrun_command():
    cmd = launch_pod.torchrun_command("c.yaml", ["--device", "cpu"], 1, 2, "10.0.0.1:29500", 8)
    assert cmd[:3] == [sys.executable, "-m", "torch.distributed.run"]
    assert cmd[3:] == ["--nnodes", "2", "--node_rank", "1", "--master_addr", "10.0.0.1",
                       "--master_port", "29500", "--nproc_per_node", "8", "-m",
                       "mindpose_tpu_torch.tools.train", "--config", "c.yaml", "--device", "cpu"]
    single = launch_pod.torchrun_command("c.yaml", [], 0, 1, None, 1)
    assert single[3:] == ["--standalone", "--nnodes", "1", "--nproc_per_node", "1", "-m",
                          "mindpose_tpu_torch.tools.train", "--config", "c.yaml"]


def test_launcher_refuses_to_guess_a_rank(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ("PROCESS_ID", "COORDINATOR_ADDRESS")}
    for extra, message in (({"NUM_PROCESSES": "2"}, "set PROCESS_ID"),
                           ({"NUM_PROCESSES": "2", "PROCESS_ID": "1"}, "COORDINATOR_ADDRESS")):
        proc = subprocess.run(
            [sys.executable, "-m", "mindpose_tpu_torch.tools.launch_pod", "--config", RECIPE,
             "--prepare-cmd", f"touch {tmp_path / 'ran'}", "--workdir", str(tmp_path)],
            cwd=ROOT, env=dict(env, **extra), capture_output=True, text=True, timeout=120)
        assert proc.returncode == 2 and message in proc.stderr, proc.stderr
    assert not (tmp_path / "ran").exists()


def test_two_hosts_prepare_once_and_train(tmp_path):
    root = str(tmp_path)
    data = (tiny_coco.write_split(os.path.join(root, "train"), TRAIN_IMAGES,
                                  tiny_coco.TRAIN_SEED),
            tiny_coco.write_val(os.path.join(root, "val")))
    ckpt_dir = os.path.join(root, "ckpt")
    log = os.path.join(root, "prepared.log")
    prepare = f"{sys.executable} -c \"open(r'{log}', 'a').write('prepared;')\""
    train_args = ["--device", "cpu", "--seed", str(SEED), "--cfg-options",
                  *_overrides(root, data, num_epochs=1, batch_size=BATCH, warmup=1,
                              val_while_train=False, ckpt_save_dir=ckpt_dir)]
    coordinator = f"127.0.0.1:{ddp_ranks.free_port()}"
    commands, logs, env = [], [], dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("PROCESS_ID", "NUM_PROCESSES", "COORDINATOR_ADDRESS", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    for host in range(HOSTS):
        commands.append(["env", f"PROCESS_ID={host}", f"NUM_PROCESSES={HOSTS}",
                         f"COORDINATOR_ADDRESS={coordinator}", sys.executable, "-c", POD_MAIN,
                         "--config", RECIPE, "--prepare-cmd", prepare, "--workdir", root,
                         "--nproc-per-node", "1", "--", *train_args])
        logs.append(os.path.join(root, f"host{host}.log"))
    outputs = ddp_ranks.run_processes(commands, logs, LAUNCH_TIMEOUT_S, "launch_pod", env=env)
    with open(log) as f:
        assert f.read() == "prepared;"  # once, on rank 0
    assert "waiting for rank 0 data preparation" in outputs[1]
    assert "preparing data" in outputs[0] and "preparing data" not in outputs[1]
    for host, out in enumerate(outputs):
        assert f"[host {host} of {HOSTS}] exec:" in out and "--node_rank" in out
    saved = load_checkpoint(os.path.join(ckpt_dir, f"{CONFIG_NAME}_last.ckpt"))
    assert saved["step"] == 1  # one step of 32 crops on each of the two hosts
