"""The PyTorch port stands alone: importing every module of boa_tpu_torch
loads neither JAX nor the JAX package, nor pandas, cv2, matplotlib or sklearn
(which the card machine is not known to have; a contrast bundle imports
sklearn when it is read), and its entry points default to the
card and raise without it unless the caller asks for the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_CHECK = r"""
import importlib, pkgutil, sys, types
# the Orthanc runtime provides `orthanc` to pacs/on_change.py: a stub here
orthanc = types.ModuleType("orthanc")
orthanc.RegisterOnChangeCallback = lambda callback: None
orthanc.ChangeType = types.SimpleNamespace(STABLE_SERIES=9)
sys.modules["orthanc"] = orthanc
import boa_tpu_torch
for m in pkgutil.walk_packages(boa_tpu_torch.__path__, "boa_tpu_torch."):
    importlib.import_module(m.name)
banned = ("jax", "jaxlib", "boa_tpu", "pandas", "cv2", "matplotlib", "sklearn")
bad = [k for k in sys.modules if k.split(".")[0] in banned]
front = {"boa_tpu_torch.cli", "boa_tpu_torch.__main__", "boa_tpu_torch.commands",
         "boa_tpu_torch.python_api", "boa_tpu_torch.measure.radiomics",
         "boa_tpu_torch.measure.shape", "boa_tpu_torch.io.dicom_seg",
         "boa_tpu_torch.io.rtstruct", "boa_tpu_torch.compute.geometry",
         "boa_tpu_torch.tools.total_segmentator", "boa_tpu_torch.tools.combine_masks",
         "boa_tpu_torch.tools.set_license", "boa_tpu_torch.tools.setup_manually",
         "boa_tpu_torch.engine", "boa_tpu_torch.engine.predict",
         "boa_tpu_torch.engine.ensembling", "boa_tpu_torch.engine.evaluation",
         "boa_tpu_torch.engine.fingerprint", "boa_tpu_torch.train",
         "boa_tpu_torch.train.variants", "boa_tpu_torch.testing.nnunet_checkpoint",
         "boa_tpu_torch.serve", "boa_tpu_torch.serve.stream", "boa_tpu_torch.serve.warmup",
         "boa_tpu_torch.ops.registration", "boa_tpu_torch.tools.evans_index",
         "boa_tpu_torch.tools.crop_to_body", "boa_tpu_torch.tools.get_modality",
         "boa_tpu_torch.tools.get_phase", "boa_tpu_torch.compute.gbm",
         "boa_tpu_torch.pacs", "boa_tpu_torch.pacs.imports", "boa_tpu_torch.pacs.util",
         "boa_tpu_torch.pacs.worker", "boa_tpu_torch.pacs.on_change",
         "boa_tpu_torch.io.storage", "boa_tpu_torch.templates",
         "boa_tpu_torch.templates.generate"}
print(len([k for k in sys.modules if k.startswith("boa_tpu_torch")]), bad,
      sorted(front - set(sys.modules)))
sys.exit(1 if bad or not front <= set(sys.modules) else 0)
"""


def test_import_loads_no_jax_and_no_reference_package():
    """The walk imports every module, the front door's (cli, __main__,
    commands), the TotalSegmentator API's (python_api, radiomics, shape,
    the DICOM-SEG and RTSTRUCT writers, the contour tracer, the tools) and
    the model-folder tools' (engine/, train/variants.py, the checkpoint
    writer in testing/), the serving layer's (serve/), the TotalSegmentator
    tools' with the registration and the GBM fitter among them, and the
    PACS layer's (pacs/, the sinks in io/storage.py, templates/), with a
    stub for the `orthanc` module that Orthanc's runtime provides."""
    r = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 20  # every subpackage was walked


_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+boa_tpu\b"
                     r"|from\s+boa_tpu(\.|\s+import\b)"
                     r"|(import|from)\s+(pandas|cv2|matplotlib)\b)", re.M)


def test_sources_import_no_jax_and_no_reference_package():
    files = sorted((ROOT / "boa_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if _IMPORT.search(f.read_text())]
    assert not offenders


def test_chip_smoke_fails_without_card_or_package(tmp_path):
    """The smoke script exits non-zero, printing no result line, when CUDA is
    unavailable, and when it sits alone without the package."""
    runs = [subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                           capture_output=True, text=True, timeout=120,
                           env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})]
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    runs.append(subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                               capture_output=True, text=True, timeout=120,
                               env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}))
    for r in runs:
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(no_cuda, tmp_path):
    from boa_tpu_torch.inference.pipeline import predict_image
    from boa_tpu_torch.inference.predictor import Predictor
    from boa_tpu_torch.io.nifti import NiftiImage
    from boa_tpu_torch.models.unet import PlainConvUNet
    from boa_tpu_torch.plans.plans import synthetic_plans
    from boa_tpu_torch.weights.convert import params_from_numpy
    from boa_tpu_torch.weights.store import (ModelStore, create_synthetic_model,
                                             init_params_numpy)

    plans = synthetic_plans(num_classes=3, patch_size=(16, 16, 16),
                            features=(4, 8))
    cfg = plans.arch_config()
    params = init_params_numpy(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        PlainConvUNet(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(plans=plans, fold_params=[params])
    create_synthetic_model(tmp_path, 297, "t", num_classes=3,
                           trainer="nnUNetTrainer_4000epochs_NoMirroring",
                           patch_size=(16, 16, 16), features=(4, 8))
    img = NiftiImage(data=np.zeros((20, 20, 20), np.int16),
                     affine=np.diag([3.0, 3.0, 3.0, 1.0]))
    with pytest.raises(RuntimeError, match="CUDA"):
        predict_image(img, "total", ModelStore(tmp_path), fast=True)
    from boa_tpu_torch.python_api import totalsegmentator

    with pytest.raises(RuntimeError, match="CUDA"):
        totalsegmentator(img, None, task="total", fast=True, store=ModelStore(tmp_path))
    # the CPU only when asked for
    assert PlainConvUNet(cfg, device="cpu").seg_heads[0].weight.device.type == "cpu"
    pred = Predictor(plans=plans, fold_params=[params], device="cpu")
    assert pred.predict(np.zeros((16, 16, 16), np.float32), (3.0, 3.0, 3.0)).shape \
        == (16, 16, 16)


def test_model_folder_entry_points_default_to_cuda(no_cuda, tmp_path):
    """The model-folder predictor, the residual and 2d networks and the
    checkpoint conversion into modules need the card unless asked for the
    CPU; `python -m boa_tpu_torch.engine.predict` without `-device` too."""
    from boa_tpu_torch.engine.predict import main, predict_folder
    from boa_tpu_torch.models.unet import ArchConfig, make_unet
    from boa_tpu_torch.weights.store import create_synthetic_model

    mdir = create_synthetic_model(tmp_path / "w", 905, "t", num_classes=3,
                                  patch_size=(16, 16, 16), features=(4, 8))
    cases = tmp_path / "cases"
    cases.mkdir()
    with pytest.raises(RuntimeError, match="CUDA"):
        predict_folder(cases, tmp_path / "o", model_dir=mdir, folds=[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-i", str(cases), "-o", str(tmp_path / "o"), "-m", str(mdir)])
    assert predict_folder(cases, tmp_path / "o", model_dir=mdir, folds=[0],
                          device="cpu") == []
    for kw in (dict(residual_encoder=True, n_blocks_per_stage=(1, 1)),
               dict(two_d=True, kernel_sizes=((3, 3, 1),) * 2,
                    strides=((1, 1, 1), (2, 2, 1)))):
        cfg = ArchConfig(**{**dict(n_stages=2, features_per_stage=(4, 8),
                                   kernel_sizes=((3, 3, 3),) * 2,
                                   strides=((1, 1, 1), (2, 2, 2)),
                                   n_conv_per_stage=(2, 2),
                                   n_conv_per_stage_decoder=(2,), num_classes=3), **kw})
        with pytest.raises(RuntimeError, match="CUDA"):
            make_unet(cfg)
        assert make_unet(cfg, "cpu").seg_heads[0].weight.device.type == "cpu"
