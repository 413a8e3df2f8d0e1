"""The port's checkpoints, and its reader of the JAX package's.

- ``utils/flax_msgpack.msgpack_restore`` gives what flax's
  ``serialization.msgpack_restore`` gives, leaf for leaf (same keys, types
  and dtypes, the same bytes): on a TrainState that the JAX package's
  ``save_checkpoint`` wrote after 2 adamw steps of the reduced HRNet, and on
  a tree of every leaf kind flax writes, chunked arrays included.
- ``utils/checkpoint``: a save/restore round trip is bitwise, and a train
  step from the restored state equals the uninterrupted run's bitwise on
  the CPU; ``load_net_state_dict`` takes either kind of file.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from mindpose_tpu.models.loss.mse import JointsMSELoss as JaxJointsMSELoss
from mindpose_tpu.models.networks import NetWithLoss as JaxNetWithLoss
from mindpose_tpu.optim import create_optimizer as jax_create_optimizer
from mindpose_tpu.parallel import build_train_step as jax_build_train_step
from mindpose_tpu.parallel import create_train_state
from mindpose_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mindpose_tpu_torch.models import create_loss, create_network_with_loss
from mindpose_tpu_torch.models.backbones.hrnet import HRNet
from mindpose_tpu_torch.models.convert import convert_net_variables
from mindpose_tpu_torch.models.heads import HRNetHead
from mindpose_tpu_torch.models.networks import Net
from mindpose_tpu_torch.optim import create_optimizer
from mindpose_tpu_torch.parallel import build_train_step
from mindpose_tpu_torch.scheduler import create_lr_scheduler
from mindpose_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_net_state_dict,
    restore_train_state,
    save_checkpoint,
)
from mindpose_tpu_torch.utils.flax_msgpack import load_variables, msgpack_restore
from tests.test_torch_hrnet import CFG, build_pair, skeleton
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)


def _assert_same_tree(got, want, path="root"):
    """Same structure, keys in the same order, same leaf types, dtypes and bits.

    A bfloat16 leaf, which flax gives as an ml_dtypes array or scalar, must
    come out as a torch.bfloat16 tensor with the same bits.
    """
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype == ml_dtypes.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(want), path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16), err_msg=path)
    elif isinstance(want, np.ndarray):
        assert type(got) is np.ndarray and got.dtype == want.dtype, path
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), path
    elif isinstance(want, np.generic):
        assert type(got) is type(want) and got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.fixture(scope="module")
def jax_train_state(tmp_path_factory):
    """(path, state): the reduced HRNet's TrainState after 2 adamw steps, saved
    by the JAX package's save_checkpoint."""
    jax_net, variables, _, x = build_pair()
    rng = np.random.RandomState(1)
    target = rng.uniform(0, 1, (2, 16, 12, 17)).astype(np.float32)
    weight = rng.uniform(0, 1, (2, 17)).astype(np.float32)
    tx = jax_create_optimizer(variables["params"], "adamw", learning_rate=1e-3,
                              weight_decay=0.05)
    state = create_train_state(variables, tx)
    step = jax_build_train_step(JaxNetWithLoss(jax_net, JaxJointsMSELoss(use_target_weight=True),
                                               has_extra_inputs=True), tx, donate=False)
    for _ in range(2):
        state, _ = step(state, jnp.asarray(x), jnp.asarray(target), jnp.asarray(weight))
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "state.msgpack")
    jax_save_checkpoint(path, state)
    return path, jax.device_get(state)


def test_reader_equals_flax_on_a_train_state(jax_train_state):
    path, _ = jax_train_state
    with open(path, "rb") as f:
        data = f.read()
    want = serialization.msgpack_restore(data)
    assert set(want) == {"step", "params", "batch_stats", "opt_state"}
    _assert_same_tree(msgpack_restore(data), want)


def test_load_variables_feeds_the_converter(jax_train_state):
    path, state = jax_train_state
    got = load_variables(path)
    assert set(got) == {"params", "batch_stats"}
    want = convert_net_variables({"params": state.params, "batch_stats": state.batch_stats},
                                 skeleton())
    sd = convert_net_variables(got, skeleton())
    assert list(sd) == list(want)
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    # a raw params tree has no batch_stats
    raw = str(path) + ".params"
    with open(raw, "wb") as f:
        f.write(serialization.to_bytes(state.params))
    _assert_same_tree(load_variables(raw)["params"],
                      serialization.msgpack_restore(serialization.to_bytes(state.params)))
    assert load_variables(raw)["batch_stats"] == {}


def _every_leaf_kind():
    rng = np.random.RandomState(0)
    return {
        "f32": rng.randn(3, 4).astype(np.float32),
        "f64": rng.randn(5),
        "bf16": np.asarray(rng.randn(2, 3), ml_dtypes.bfloat16),
        "i32": rng.randint(-2**31, 2**31 - 1, (7,), dtype=np.int64).astype(np.int32),
        "u8": rng.randint(0, 256, (2, 2)).astype(np.uint8),
        "bool": rng.rand(6) > 0.5,
        "empty array": np.zeros((0, 3), np.float32),
        "empty bf16": np.zeros((2, 0), ml_dtypes.bfloat16),
        "np f32 scalar": np.float32(1.25),
        "np i64 scalar": np.int64(-3),
        "np bool scalar": np.bool_(True),
        "np bf16 scalar": ml_dtypes.bfloat16(0.1),
        "int": 7, "negative int": -100, "int64": 2**40, "uint64": 2**63 + 5, "small": -3,
        "float": 0.1, "inf": float("inf"),
        "bool true": True, "bool false": False, "none": None,
        "str": "pixel_std", "long str": "x" * 300, "bytes": bytes(range(256)),
        "complex": 1.5 - 2j,
        "empty dict": {},
        "nested": {"a": {"b": np.arange(4, dtype=np.int32)}},
        "big map": {f"k{i}": i for i in range(20)},
        "chunked": rng.randn(5, 7).astype(np.float32),
        "chunked bf16": np.asarray(rng.randn(40), ml_dtypes.bfloat16),
    }


def test_reader_equals_flax_on_every_leaf_kind(monkeypatch):
    # a chunk limit of 64 B chunks the two arrays named "chunked" and none of the others
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = _every_leaf_kind()
    data = serialization.to_bytes(tree)
    want = serialization.msgpack_restore(data)
    assert isinstance(want["chunked"], np.ndarray) and want["chunked"].shape == (5, 7)
    assert b"__msgpack_chunked_array__" in data
    _assert_same_tree(msgpack_restore(data), want)
    # msgpack arrays (lists) and an array of 20 maps, through the low-level serializer
    data = serialization.msgpack_serialize({"list": [1, 2.5, "a", [None, True]],
                                            "maps": [{"x": i} for i in range(20)]})
    _assert_same_tree(msgpack_restore(data), serialization.msgpack_restore(data))


def test_reader_rejects_truncated_and_trailing_data():
    data = serialization.to_bytes({"w": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="ends inside"):
        msgpack_restore(data[:-1])
    with pytest.raises(ValueError, match="after the object"):
        msgpack_restore(data + b"\x00")


def _port_net():
    torch.manual_seed(0)
    return Net(HRNet(CFG), HRNetHead(8, 17))


def _port_step(net):
    optimizer = create_optimizer(net, "adamw", learning_rate=1e-3, weight_decay=0.05)
    schedule = create_lr_scheduler("warmup_multi_step_decay", lr=1e-3, total_epochs=10,
                                   steps_per_epoch=2, warmup=3, milestones=[4, 8])
    nwl = create_network_with_loss(net, create_loss("joint_mse", use_target_weight=True),
                                   has_extra_inputs=True)
    return optimizer, build_train_step(nwl, optimizer, schedule)


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(2, 3, 64, 48).astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 1, (2, 17, 16, 12)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 1, (2, 17)).astype(np.float32)))


def _assert_equal_states(a, b):
    assert type(a) is type(b)
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_equal_states(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal_states(x, y)
    else:
        assert a == b


def test_port_checkpoint_round_trip_and_resume(tmp_path):
    net = _port_net()
    optimizer, step = _port_step(net)
    for seed in (1, 2):
        step(*_batch(seed))
    path = str(tmp_path / "ckpt" / "last.pt")
    save_checkpoint(path, net, optimizer, step.count)
    assert not [p for p in (tmp_path / "ckpt").iterdir() if ".tmp" in p.name]

    net2 = Net(HRNet(CFG), HRNetHead(8, 17))
    optimizer2, step2 = _port_step(net2)
    step2.count = restore_train_state(path, net2, optimizer2)
    assert step2.count == step.count == 2
    _assert_equal_states(net2.state_dict(), net.state_dict())
    _assert_equal_states(optimizer2.state_dict(), optimizer.state_dict())
    assert load_checkpoint(path)["step"] == 2

    # one more step from the restored state equals the uninterrupted run, bitwise
    loss = step(*_batch(3))
    loss2 = step2(*_batch(3))
    assert torch.equal(loss, loss2)
    _assert_equal_states(net2.state_dict(), net.state_dict())
    _assert_equal_states(optimizer2.state_dict(), optimizer.state_dict())


def test_one_loader_for_either_file(tmp_path, jax_train_state):
    net = _port_net()
    path = str(tmp_path / "net.pt")
    save_checkpoint(path, net)
    fresh = Net(HRNet(CFG), HRNetHead(8, 17))
    fresh.load_state_dict(load_net_state_dict(path, fresh), strict=True)
    _assert_equal_states(fresh.state_dict(), net.state_dict())
    with pytest.raises(ValueError, match="no optimizer state"):
        restore_train_state(path, fresh, _port_step(fresh)[0])

    jax_path, state = jax_train_state
    fresh.load_state_dict(load_net_state_dict(jax_path, fresh), strict=True)
    want = convert_net_variables({"params": state.params, "batch_stats": state.batch_stats}, fresh)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k
