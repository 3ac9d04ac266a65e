"""nnU-Net `.pth` checkpoints in the port (weights/convert.py, store.py,
testing/nnunet_checkpoint.py) against the reference's converter
(boa_tpu/weights/convert.py): the state dicts of tests/torch_mirror.TorchUNet
(the real key layout, aliases included) give the reference's parameter
pytree exactly (`np.array_equal`, same dtypes and structure)."""

import numpy as np
import pytest
import torch

import jax

from boa_tpu.models import unet as ju
from boa_tpu.weights import convert as jcv
from boa_tpu.weights import store as jstore
from boa_tpu_torch.models import unet as tu
from boa_tpu_torch.testing import nnunet_checkpoint as nc
from boa_tpu_torch.weights import convert as cv
from boa_tpu_torch.weights import store as tstore

from tests.torch_mirror import TorchUNet, full_checkpoint, real_format_plans

_BASE = dict(n_stages=3, features_per_stage=(4, 8, 16),
             kernel_sizes=((3, 3, 3),) * 3,
             strides=((1, 1, 1), (2, 2, 2), (2, 2, 2)),
             n_conv_per_stage=(2, 2, 2), n_conv_per_stage_decoder=(2, 2),
             num_classes=3)
ARCHS = {
    "plain": _BASE,
    "plain_4stage": dict(_BASE, n_stages=4, features_per_stage=(4, 8, 16, 16),
                         kernel_sizes=((3, 3, 3),) * 4,
                         strides=((1, 1, 1),) + ((2, 2, 2),) * 3,
                         n_conv_per_stage=(2, 2, 2, 2), n_conv_per_stage_decoder=(2, 2, 2)),
    "residual": dict(_BASE, residual_encoder=True, n_blocks_per_stage=(1, 2, 2)),
    "residual_1conv_decoder": dict(_BASE, residual_encoder=True,
                                   n_blocks_per_stage=(1, 3, 2),
                                   n_conv_per_stage_decoder=(1, 1)),
    "aniso": dict(_BASE, kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
                  strides=((1, 1, 1), (2, 2, 1), (2, 2, 2))),
}


def _state(name, ds=False, seed=0):
    torch.manual_seed(seed)
    return TorchUNet(ju.ArchConfig(**ARCHS[name]), deep_supervision=ds).eval().state_dict()


def _assert_same_tree(got, want):
    lg = jax.tree_util.tree_leaves_with_path(got)
    lw = jax.tree_util.tree_leaves_with_path(want)
    assert [k for k, _ in lg] == [k for k, _ in lw]
    for (k, a), (_, b) in zip(lg, lw):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k


@pytest.mark.parametrize("prefix", ["", "module.", "_orig_mod."])
@pytest.mark.parametrize("ds", [False, True])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_convert_state_dict_equals_reference(name, ds, prefix):
    state = {prefix + k: v for k, v in _state(name, ds).items()}
    cfg = dict(ARCHS[name], deep_supervision=ds)
    if prefix:  # the prefixes are stripped by the file loader
        with pytest.raises(ValueError, match="no recognizable"):
            cv.convert_state_dict(state, tu.ArchConfig(**cfg))
        state = {k.removeprefix(prefix): v for k, v in state.items()}
    got = cv.convert_state_dict(state, tu.ArchConfig(**cfg), strict=True)
    want = jcv.convert_state_dict(state, ju.ArchConfig(**cfg), strict=True)
    _assert_same_tree(got, want)


@pytest.mark.parametrize("ddp", [False, True])
@pytest.mark.parametrize("name", ["plain", "residual"])
def test_convert_checkpoint_of_saved_full_checkpoint(tmp_path, name, ddp):
    """A `torch.save`d real-format checkpoint (optimizer state, init args,
    DDP prefixes) through both packages' file loaders."""
    torch.manual_seed(1)
    net = TorchUNet(ju.ArchConfig(**ARCHS[name])).eval()
    path = tmp_path / "checkpoint_final.pth"
    torch.save(full_checkpoint(net, ddp_prefix=ddp), path)
    state = cv.load_torch_state_dict(path)
    assert state.keys() == jcv.load_torch_state_dict(path).keys()
    assert not any(k.startswith("module.") for k in state)
    _assert_same_tree(cv.convert_checkpoint(path, tu.ArchConfig(**ARCHS[name])),
                      jcv.convert_checkpoint(path, ju.ArchConfig(**ARCHS[name])))


def test_strict_rejects_unknown_keys():
    state = dict(_state("plain"), **{"decoder.extra_head.weight": torch.zeros(3)})
    for conv, arch in ((cv, tu.ArchConfig), (jcv, ju.ArchConfig)):
        with pytest.raises(ValueError, match="not consumed"):
            conv.convert_state_dict(state, arch(**ARCHS["plain"]), strict=True)
        conv.convert_state_dict(state, arch(**ARCHS["plain"]))  # lenient by default
    # a residual state dict read as a plain config leaves its blocks unconsumed
    with pytest.raises(ValueError, match="not consumed"):
        cv.convert_state_dict(_state("residual"), tu.ArchConfig(**ARCHS["plain"]),
                              strict=True)
    with pytest.raises(ValueError, match="no recognizable"):
        cv.convert_state_dict({"foo.weight": torch.zeros(1)}, tu.ArchConfig(**ARCHS["plain"]))


def test_two_stem_convs_raise():
    state = _state("residual")
    extra = {k.replace("stem.convs.0.", "stem.convs.1."): v for k, v in state.items()
             if k.startswith("encoder.stem.convs.0.")}
    state.update(extra)
    for conv, arch in ((cv, tu.ArchConfig), (jcv, ju.ArchConfig)):
        with pytest.raises(ValueError, match="stem has 2 convs"):
            conv.convert_state_dict(state, arch(**ARCHS["residual"]))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_checkpoint_writer_matches_mirror_layout(name):
    """testing/nnunet_checkpoint.py's network_weights: the keys of
    full_checkpoint's network_weights, in order, and the same tensors, from
    the converted pytree; aliases share the primary key's tensor."""
    torch.manual_seed(2)
    net = TorchUNet(ju.ArchConfig(**ARCHS[name])).eval()
    ref = full_checkpoint(net)
    cfg = tu.ArchConfig(**ARCHS[name])
    params = cv.convert_state_dict(ref["network_weights"], cfg, strict=True)
    ck = nc.checkpoint(params, cfg, trainer_name="nnUNetTrainer", mirror_axes=(0, 1, 2))
    got, want = ck["network_weights"], ref["network_weights"]
    assert list(got) == list(want)
    assert all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want)
    k0 = next(k for k in got if k.endswith("conv.weight"))
    assert got[k0] is got["decoder." + k0]
    assert got[k0] is got[k0.replace("conv.weight", "all_modules.0.weight")]
    for key in ("trainer_name", "inference_allowed_mirroring_axes"):
        assert ck[key] == ref[key]
    assert ck["init_args"].keys() == ref["init_args"].keys()


def _fold_pth(tmp_path, name="plain", seed=3):
    """A store folder (plans of tests/torch_mirror.real_format_plans) whose
    fold 0 holds only a real-format checkpoint_final.pth."""
    import json

    torch.manual_seed(seed)
    cfg = ju.ArchConfig(**ARCHS[name])
    net = TorchUNet(cfg).eval()
    plans = real_format_plans(cfg, spacing=(2.0, 2.0, 2.0), patch=(16, 16, 16))
    if cfg.residual_encoder:
        arch = plans["configurations"]["3d_fullres"]["architecture"]
        arch["network_class_name"] = ("dynamic_network_architectures.architectures."
                                      "residual_unet.ResidualEncoderUNet")
        kw = arch["arch_kwargs"]
        kw["n_blocks_per_stage"] = list(cfg.n_blocks_per_stage)
        del kw["n_conv_per_stage"]
    mdir = tmp_path / "store" / "Dataset077_Toy" / "nnUNetTrainer__nnUNetPlans__3d_fullres"
    (mdir / "fold_0").mkdir(parents=True)
    (mdir / "plans.json").write_text(json.dumps(plans))
    (mdir / "dataset.json").write_text(json.dumps(
        {"labels": {"background": 0, "a": 1, "b": 2}, "channel_names": {"0": "CT"}}))
    torch.save(full_checkpoint(net), mdir / "fold_0" / "checkpoint_final.pth")
    return mdir


@pytest.mark.parametrize("name", ["plain", "residual"])
def test_store_load_converts_and_caches_pth(tmp_path, name):
    mdir = _fold_pth(tmp_path, name)
    store = tstore.ModelStore(tmp_path / "store")
    plans, [params] = store.load(77, folds=(0,))
    npz = mdir / "fold_0" / "checkpoint_final.npz"
    assert npz.exists()
    _, [again] = store.load(77, folds=(0,))          # from the cached .npz
    _assert_same_tree(again, params)
    want = jcv.convert_checkpoint(mdir / "fold_0" / "checkpoint_final.pth",
                                  ju.ArchConfig(**ARCHS[name]))
    _assert_same_tree(params, want)
    _assert_same_tree(jcv.load_params_npz(npz, None), want)   # the reference reads it
    cfg = plans.arch_config()
    m1, m2 = (cv.params_from_numpy(p, cfg, "cpu") for p in (params, again))
    assert all(torch.equal(a, b) for a, b in zip(m1.state_dict().values(),
                                                 m2.state_dict().values()))
    with pytest.raises(FileNotFoundError, match="checkpoint_final"):
        store.load(77, folds=(3,))


def test_partial_npz_cache_is_never_read(tmp_path, monkeypatch):
    """A conversion cut off while it writes the `.npz` leaves nothing under
    the cache's name; a partial archive a killed process left in the fold is
    not read; loads racing on one uncached fold all get the converted
    parameters."""
    from concurrent.futures import ThreadPoolExecutor

    from boa_tpu_torch.io import npz as tnpz

    mdir = _fold_pth(tmp_path, "plain")
    fold = mdir / "fold_0"
    cfg = ju.ArchConfig(**ARCHS["plain"])
    want = jcv.convert_checkpoint(fold / "checkpoint_final.pth", cfg)
    real_deflate, calls = tnpz._deflate, []

    def failing(data, level):
        calls.append(1)
        if len(calls) == 3:
            raise KeyboardInterrupt
        return real_deflate(data, level)
    monkeypatch.setattr(tnpz, "_deflate", failing)
    with pytest.raises(KeyboardInterrupt):
        tstore.load_fold(fold, cfg)
    monkeypatch.setattr(tnpz, "_deflate", real_deflate)
    assert sorted(p.name for p in fold.iterdir()) == ["checkpoint_final.pth"]
    # a killed writer's leftover: the first half of a whole archive
    cv.save_params_npz(want, tmp_path / "whole.npz")
    data = (tmp_path / "whole.npz").read_bytes()
    (fold / ".checkpoint_final.npz.0123abcd.part").write_bytes(data[:len(data) // 2])
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(lambda _: tstore.load_fold(fold, cfg), range(4)))
    for params in got + [cv.load_params_npz(fold / "checkpoint_final.npz")]:
        _assert_same_tree(params, want)
    assert sorted(p.name for p in fold.iterdir()) == [
        ".checkpoint_final.npz.0123abcd.part", "checkpoint_final.npz",
        "checkpoint_final.pth"]


def test_import_torch_model_folder_matches_reference(tmp_path):
    mdir = _fold_pth(tmp_path, "residual", seed=4)
    src = tmp_path / "src" / mdir.parent.name / mdir.name
    src.parent.mkdir(parents=True)
    mdir.rename(src)
    got = tstore.import_torch_model_folder(src, tmp_path / "port")
    want = jstore.import_torch_model_folder(src, tmp_path / "ref")
    assert got.relative_to(tmp_path / "port") == want.relative_to(tmp_path / "ref")
    for f in ("plans.json", "dataset.json"):
        assert (got / f).read_bytes() == (want / f).read_bytes()
    _assert_same_tree(cv.load_params_npz(got / "fold_0" / "checkpoint_final.npz"),
                      jcv.load_params_npz(want / "fold_0" / "checkpoint_final.npz", None))
    plans, [params] = tstore.ModelStore(tmp_path / "port").load(77)
    assert plans.arch_config().residual_encoder
