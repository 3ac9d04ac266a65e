"""Pre-2.2 nnU-Net plans in the port (`plans/plans.py:_reconstruct_old_arch`)
against the reference's, and the CLI's `--radiomics` help against the
reference's.

A configuration written before nnU-Net 2.2 has no `architecture` entry,
only the old keys (`UNet_class_name`, `UNet_base_num_features`,
`unet_max_num_features`, `n_conv_per_stage_encoder`/`_decoder`,
`pool_op_kernel_sizes`, `conv_kernel_sizes`). Both packages rebuild the
entry from them, for PlainConvUNet and ResidualEncoderUNet: the same
`conf` and `ArchConfig`, and a model folder with such plans predicts the
same labels as with the 2.2 plans it came from.
"""

import copy
import dataclasses
import json

import numpy as np
import pytest

from boa_tpu import cli as jcli
from boa_tpu.plans import plans as jplans
from boa_tpu_torch import cli as tcli
from boa_tpu_torch.engine import predict as tep
from boa_tpu_torch.io import nifti
from boa_tpu_torch.plans import plans as tplans
from boa_tpu_torch.testing.nnunet_checkpoint import save_checkpoint
from boa_tpu_torch.weights.store import init_params_numpy


def _old_plans(unet_class: str, n_stages: int, base: int, cap: int,
               patch=(32, 32, 32)) -> dict:
    """A plans dict whose 3d_fullres configuration has only the old keys."""
    plans = copy.deepcopy(tplans.synthetic_plans(
        num_classes=3, patch_size=patch, features=(8,) * n_stages).plans)
    conf = plans["configurations"]["3d_fullres"]
    del conf["architecture"]
    conf.update({
        "UNet_class_name": unet_class,
        "UNet_base_num_features": base,
        "unet_max_num_features": cap,
        "n_conv_per_stage_encoder": [2] * n_stages,
        "n_conv_per_stage_decoder": [2] * (n_stages - 1),
        "pool_op_kernel_sizes": [[1, 1, 1]] + [[2, 2, 2]] * (n_stages - 1),
        "conv_kernel_sizes": [[3, 3, 3]] * n_stages,
    })
    return plans


_DATASET = {"labels": {"background": 0, "a": 1, "b": 2}, "channel_names": {"0": "CT"},
            "file_ending": ".nii.gz"}


@pytest.mark.parametrize("unet_class", ["PlainConvUNet", "ResidualEncoderUNet"])
def test_old_plans_rebuild_the_reference_architecture(unet_class):
    plans = _old_plans(unet_class, 6, 32, 320, patch=(128, 128, 128))
    got = tplans.ModelPlans(copy.deepcopy(plans), _DATASET)
    want = jplans.ModelPlans(copy.deepcopy(plans), _DATASET)
    assert got.conf == want.conf
    kw = got.conf["architecture"]["arch_kwargs"]
    assert kw["features_per_stage"] == [32, 64, 128, 256, 320, 320]
    assert ("n_conv_per_stage" if unet_class == "PlainConvUNet"
            else "n_blocks_per_stage") in kw
    assert dataclasses.asdict(got.arch_config()) == dataclasses.asdict(want.arch_config())
    assert got.arch_config().features_per_stage == (32, 64, 128, 256, 320, 320)
    assert got.arch_config().residual_encoder == (unet_class == "ResidualEncoderUNet")


def test_old_plans_model_folder_predicts_as_the_new_plans(tmp_path):
    """One `.pth` fold under old and under 2.2 plans, through
    `load_model_folder` and `predict_folder` on the CPU: equal labels."""
    old = _old_plans("PlainConvUNet", 2, 4, 8, patch=(16, 16, 16))
    new = tplans.ModelPlans(copy.deepcopy(old), _DATASET)
    cfg = new.arch_config()
    params = init_params_numpy(cfg, 3)
    dirs = {}
    for name, plans in (("old", old), ("new", new.plans)):
        mdir = tmp_path / name / "nnUNetTrainer__nnUNetPlans__3d_fullres"
        save_checkpoint(mdir / "fold_0" / "checkpoint_final.pth", params, cfg)
        (mdir / "plans.json").write_text(json.dumps(plans))
        (mdir / "dataset.json").write_text(json.dumps(_DATASET))
        dirs[name] = mdir
    assert "architecture" not in json.loads((dirs["old"] / "plans.json").read_text())[
        "configurations"]["3d_fullres"]
    loaded, folds = tep.load_model_folder(dirs["old"], [0])
    assert loaded.arch_config() == cfg and len(folds) == 1
    cases = tmp_path / "cases"
    cases.mkdir()
    data = np.random.default_rng(4).normal(0, 200, (20, 18, 16)).astype(np.int16)
    nifti.save(nifti.NiftiImage(data=data, affine=np.diag([3.0, 3.0, 3.0, 1.0])),
               cases / "c_0000.nii.gz")
    labels = {}
    for name, mdir in dirs.items():
        out = tep.predict_folder(cases, tmp_path / f"pred_{name}", model_dir=mdir,
                                 folds=[0], disable_tta=True, device="cpu")
        labels[name] = np.asarray(nifti.load(out[0]).data)
    assert labels["old"].shape == (20, 18, 16)
    np.testing.assert_array_equal(labels["old"], labels["new"])


def _help(parser, flag: str) -> str:
    return next(a.help for a in parser._actions if flag in a.option_strings)


def test_radiomics_help_equals_the_reference():
    assert _help(tcli.get_parser(), "--radiomics") == _help(jcli.get_parser(), "--radiomics")
    assert "not ported" not in tcli.get_parser().format_help()
