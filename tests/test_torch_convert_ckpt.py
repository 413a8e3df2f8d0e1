"""The port's ``tools/convert_ckpt.py`` against the JAX package's conversion, on the CPU.

A backbone is written, from a numpy seed, as a published checkpoint would
be: a MindSpore ``.ckpt`` (the JAX package's ``export_backbone_state`` with
MindSpore names, then ``write_ms_checkpoint``), a torch ``.pth`` (torch
names under ``state_dict``, with a classifier the backbone has no use for;
a ViT's position embedding with MAE's class token) and an ``.npz`` (torch
names under a ``module.`` prefix). Each file is converted twice: by the
port's CLI (``python3 -m mindpose_tpu_torch.tools.convert_ckpt ... --check``)
into a port file, and by the JAX package's ``convert_backbone_state`` into
a flax msgpack file. ``load_pretrained_backbone`` loads each into a port net
from one start: the two nets are equal leaf for leaf, and equal to the
backbone written (save the position grid, resized from 14x14 to 16x12 in
both). The backbones: ResNet-50; HRNet-W32's structure at width 8
(``hrnet_mapping(32)`` names it); ViT-B's width and heads at 2 of its 12
blocks, an arch the test adds to both converters' tables.

Then: the missing and unused names equal JAX's; a source missing a tensor
is refused without ``--allow-missing``; ``--check`` catches a wrong shape;
and a converted file served over HTTP on 127.0.0.1 loads through
``load_pretrained_backbone``'s download, md5 checked.
"""
import hashlib
import os

import numpy as np
import pytest
import torch
from flax import serialization

from mindpose_tpu.models.backbones import convert as jax_convert
from mindpose_tpu.utils.ms_ckpt import read_ms_checkpoint as jax_read_ms_checkpoint
from mindpose_tpu.utils.ms_ckpt import write_ms_checkpoint as jax_write_ms_checkpoint
from mindpose_tpu_torch.models import create_head
from mindpose_tpu_torch.models.backbones.hrnet import HRNet, w_cfg
from mindpose_tpu_torch.models.backbones.resnet import ResNet
from mindpose_tpu_torch.models.backbones.vit import ViT
from mindpose_tpu_torch.models.convert import (
    export_variables,
    hrnet_mapping,
    num_heads,
    resnet_mapping,
    vit_mapping,
)
from mindpose_tpu_torch.models.convert_source import convert_backbone_source
from mindpose_tpu_torch.models.networks import Net
from mindpose_tpu_torch.register import list_components, register
from mindpose_tpu_torch.tools import convert_ckpt
from mindpose_tpu_torch.utils.checkpoint import load_pretrained_backbone
from mindpose_tpu_torch.utils.download import DownLoad
from tests.fixtures.loopback import serve_directory
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

NARROW_HRNET = "hrnet_w8_convert_test"  # hrnet_w32's modules, branches and blocks at width 8
SHALLOW_VIT = "vit_b_depth2_convert_test"  # vit_b's width and heads, 2 blocks
VIT_SOURCE_SIZE = (224, 224)  # MAE's: a 14x14 grid and a class token
FORMATS = (".ckpt", ".pth", ".npz")
CLASSIFIER = {"fc.weight": np.ones((10, 4), np.float32), "fc.bias": np.zeros(10, np.float32)}


def _narrow_hrnet(pretrained=False, ckpt_url="", in_channels=3, **kwargs):
    return HRNet(w_cfg(8), in_channels=in_channels)


def _shallow_vit(pretrained=False, ckpt_url="", in_channels=3, **kwargs):
    return ViT(hidden_dim=768, depth=2, num_heads=12, in_channels=in_channels, **kwargs)


# name: (the JAX converter's arch, the port CLI's arch, the source backbone, its flax entries)
ARCHS = {
    "resnet50": ("resnet50", "resnet50", lambda: ResNet((3, 4, 6, 3)),
                 lambda b: resnet_mapping(b.block_counts)),
    "hrnet_w32": ("hrnet_w32", NARROW_HRNET, lambda: _narrow_hrnet(),
                  lambda b: hrnet_mapping(b.stage_cfg)),
    "vit_b": (SHALLOW_VIT, SHALLOW_VIT, lambda: _shallow_vit(image_size=VIT_SOURCE_SIZE),
              lambda b: vit_mapping(b.depth)),
}


@pytest.fixture(autouse=True)
def archs(monkeypatch):
    """The test's arches in the port's registry and in the JAX converter's ViT table."""
    if NARROW_HRNET not in list_components("backbone"):
        register("backbone", extra_name=NARROW_HRNET)(_narrow_hrnet)
        register("backbone", extra_name=SHALLOW_VIT)(_shallow_vit)
    monkeypatch.setitem(jax_convert.VIT_ARCHS, SHALLOW_VIT, dict(hidden=768, heads=12, depth=2))


def _empty(build):
    """``build()``'s module with uninitialized tensors: no init draws, which for
    ResNet-50 take a second."""
    with torch.device("meta"):
        module = build()
    return module.to_empty(device="cpu")


def _fill_(backbone, seed):
    """Every tensor of ``backbone`` from a numpy seed (variances in [0.5, 1.5])."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in backbone.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            values = (rng.uniform(0.5, 1.5, t.shape) if name.endswith("running_var")
                      else 0.05 * rng.standard_normal(t.shape))
            t.copy_(torch.from_numpy(values.astype(np.float32)))
    return backbone


def _net(backbone):
    """A port net on ``backbone`` whose head the mappings know."""
    if isinstance(backbone, HRNet):
        head = create_head("hrnet_head", in_channels=backbone.out_channels)
    else:
        head = create_head("simple_baseline_head", in_channels=backbone.out_channels,
                           num_deconv_layers=1, num_deconv_filters=(16,),
                           num_deconv_kernels=(4,))
    return Net(backbone, head)


def _target_build(name):
    """The net both conversions load into (a ViT at 256x192)."""
    return lambda: _net(_shallow_vit() if name == "vit_b" else ARCHS[name][2]())


@pytest.fixture(scope="module")
def starts():
    """Each target net's start, from a numpy seed: name -> state_dict."""
    return {name: _fill_(_empty(_target_build(name)), seed=99).state_dict() for name in ARCHS}


def _target_net(name, starts):
    net = _empty(_target_build(name))
    net.load_state_dict(starts[name], strict=True)
    return net


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Each backbone written from a numpy seed in each format: name -> (the
    backbone, {format: path})."""
    root = tmp_path_factory.mktemp("sources")
    out = {}
    for seed, (name, (jax_arch, _, build, entries)) in enumerate(ARCHS.items()):
        if name == "vit_b":  # the JAX converter's table names the shallow ViT
            jax_convert.VIT_ARCHS[SHALLOW_VIT] = dict(hidden=768, heads=12, depth=2)
        backbone = _fill_(_empty(build), seed)
        flax = export_variables(backbone.state_dict(), entries(backbone), num_heads(backbone))
        ms = jax_convert.export_backbone_state(jax_arch, flax, naming="mindspore")
        torch_named = jax_convert.export_backbone_state(jax_arch, flax, naming="torch")
        if name == "vit_b":
            del jax_convert.VIT_ARCHS[SHALLOW_VIT]
            pos = torch_named["pos_embed"]  # MAE's class token before the grid
            torch_named["pos_embed"] = np.concatenate([np.full_like(pos[:, :1], 0.5), pos], 1)
        paths = {ext: str(root / f"{name}{ext}") for ext in FORMATS}
        jax_write_ms_checkpoint(paths[".ckpt"], ms)
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                                   dict(torch_named, **CLASSIFIER).items()}}, paths[".pth"])
        np.savez(paths[".npz"], **{f"module.{k}": v for k, v in torch_named.items()})
        out[name] = (backbone, paths)
    return out


def _jax_load_source(path):
    """The JAX tool's ``load_source`` (tools/convert_ckpt.py:38)."""
    ext = os.path.splitext(path)[1]
    if ext == ".ckpt":
        return jax_read_ms_checkpoint(path)
    if ext == ".pth":
        return {k: v.numpy() for k, v in
                torch.load(path, map_location="cpu", weights_only=True)["state_dict"].items()}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_converted_backbones_load_as_jax_s_conversion(sources, starts, tmp_path, name, fmt):
    jax_arch, port_arch = ARCHS[name][:2]
    backbone, paths = sources[name]
    out = str(tmp_path / "port.pth")
    convert_ckpt.main(["--src", paths[fmt], "--arch", port_arch, "--out", out, "--check"])
    variables, missing, _ = jax_convert.convert_backbone_state(jax_arch,
                                                               _jax_load_source(paths[fmt]))
    assert missing == []
    flax_path = str(tmp_path / "jax.msgpack")
    with open(flax_path, "wb") as f:
        f.write(serialization.msgpack_serialize(variables))

    port_net, jax_net = _target_net(name, starts), _target_net(name, starts)
    count = load_pretrained_backbone(out, port_net)
    assert count == load_pretrained_backbone(flax_path, jax_net) > 0
    got, want = port_net.state_dict(), jax_net.state_dict()
    assert list(got) == list(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    written = backbone.state_dict()
    for key, value in port_net.backbone.state_dict().items():
        if key == "pos_embed":  # resized from the source's 14x14 grid onto 16x12
            assert value.shape == (1, 16, 12, 768) and written[key].shape == (1, 14, 14, 768)
        elif not key.endswith("num_batches_tracked"):
            assert torch.equal(value, written[key]), key


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_missing_and_unused_names_equal_jax_s(sources, tmp_path, name):
    jax_arch, port_arch = ARCHS[name][:2]
    _, paths = sources[name]
    source = _jax_load_source(paths[".pth"])
    for key in sorted(source)[::40]:
        del source[key]
    source["extra.weight"] = np.zeros(3, np.float32)
    _, want_missing, want_unused = jax_convert.convert_backbone_state(jax_arch, dict(source))
    with torch.device("meta"):
        backbone = ARCHS[name][2]()
    _, missing, unused = convert_backbone_source(backbone, dict(source))
    assert missing and sorted(missing) == sorted(want_missing)
    assert "extra.weight" in unused and unused == sorted(want_unused)

    partial = str(tmp_path / "partial.npz")
    np.savez(partial, **source)
    out = str(tmp_path / "out.pth")
    with pytest.raises(SystemExit, match="allow-missing"):
        convert_ckpt.main(["--src", partial, "--arch", port_arch, "--out", out])
    assert not os.path.exists(out)
    convert_ckpt.main(["--src", partial, "--arch", port_arch, "--out", out, "--allow-missing"])
    assert sorted(torch.load(out, weights_only=True)) == sorted(
        k for k in backbone.state_dict() if k not in missing
        and not k.endswith("num_batches_tracked"))


def test_check_catches_a_wrong_shape(sources, tmp_path):
    _, paths = sources["hrnet_w32"]  # width 8, against hrnet_w32's shapes
    out = str(tmp_path / "out.pth")
    with pytest.raises(SystemExit, match="shape check failed"):
        convert_ckpt.main(["--src", paths[".ckpt"], "--arch", "hrnet_w32", "--out", out,
                           "--check"])
    with pytest.raises(ValueError, match="extension"):
        convert_ckpt.load_source(str(tmp_path / "weights.h5"))


def test_a_url_downloads_md5_checked_and_loads(sources, starts, tmp_path):
    _, paths = sources["hrnet_w32"]
    served = tmp_path / "served"
    out = str(served / "hrnet_w8.pth")
    convert_ckpt.main(["--src", paths[".ckpt"], "--arch", NARROW_HRNET, "--out", out])
    with open(out, "rb") as f:
        md5 = hashlib.md5(f.read()).hexdigest()
    root = str(tmp_path / "downloads")
    local, remote = _target_net("hrnet_w32", starts), _target_net("hrnet_w32", starts)
    with serve_directory(str(served)) as url:
        count = load_pretrained_backbone(f"{url}/hrnet_w8.pth", remote, download_root=root)
        with pytest.raises(RuntimeError, match="md5 mismatch"):
            DownLoad().download_url(f"{url}/hrnet_w8.pth", path=str(tmp_path / "other"),
                                    md5="0" * 32)
    assert count == load_pretrained_backbone(out, local) > 0
    got, want = remote.state_dict(), local.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    downloaded = os.path.join(root, "hrnet_w8.pth")
    assert DownLoad.calculate_md5(downloaded) == md5
    # the server is gone: a file already downloaded with its md5 is used as it is
    assert DownLoad().download_url(f"{url}/hrnet_w8.pth", path=root, md5=md5) == downloaded
