"""Task registry: per-model inference configuration.

Counterpart of `boa_tpu/tasks/registry.py`: the TotalSegmentator task table
(task ids, resample spacing, trainer, crop organs + addon, folds, license
gating) and the two BCA tasks (ids 542/543, slice-thickness-only resample
to 5 mm, 5 folds, fold 0 in fast mode), as a declarative table.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TaskConfig:
    name: str
    task_ids: tuple[int, ...]
    # target spacing in mm; None = native spacing; one value = isotropic
    resample: tuple[float, float, float] | None
    trainer: str
    model: str = "3d_fullres"
    folds: tuple[int, ...] | None = (0,)
    crop: tuple[str, ...] | None = None  # organs from `total` used to crop
    crop_addon: tuple[int, int, int] = (3, 3, 3)
    # only resample slice thickness (z), keep in-plane spacing (BCA models)
    resample_only_thickness: bool = False
    license_required: bool = False
    # model whose output provides the crop organs (default `total`; teeth
    # crops from craniofacial_structures — python_api.py crop_model)
    crop_model: str = "total"
    # postprocessing
    remove_outside: tuple[str, ...] | None = None  # masks for remove-outside
    remove_outside_dilation_mm: float | None = None
    keep_largest_blob: bool = False
    multilabel: bool = True


def _iso(v: float) -> tuple[float, float, float]:
    return (v, v, v)


# --- TotalSegmentator tasks used by BOA (python_api.py task table) ---
TASKS: dict[str, TaskConfig] = {
    "total": TaskConfig(
        name="total",
        task_ids=(291, 292, 293, 294, 295),
        resample=_iso(1.5),
        trainer="nnUNetTrainerNoMirroring",
    ),
    "total_fast": TaskConfig(
        name="total_fast",
        task_ids=(297,),
        resample=_iso(3.0),
        trainer="nnUNetTrainer_4000epochs_NoMirroring",
    ),
    "total_fastest": TaskConfig(
        name="total_fastest",
        task_ids=(298,),
        resample=_iso(6.0),
        trainer="nnUNetTrainer_4000epochs_NoMirroring",
    ),
    "lung_vessels": TaskConfig(
        name="lung_vessels",
        task_ids=(258,),
        resample=None,
        trainer="nnUNetTrainer",
        crop=(
            "lung_upper_lobe_left",
            "lung_lower_lobe_left",
            "lung_upper_lobe_right",
            "lung_middle_lobe_right",
            "lung_lower_lobe_right",
        ),
    ),
    "cerebral_bleed": TaskConfig(
        name="cerebral_bleed",
        task_ids=(150,),
        resample=None,
        trainer="nnUNetTrainer",
        crop=("brain",),
    ),
    "hip_implant": TaskConfig(
        name="hip_implant",
        task_ids=(260,),
        resample=None,
        trainer="nnUNetTrainer",
        crop=("femur_left", "femur_right", "hip_left", "hip_right"),
    ),
    "body": TaskConfig(
        name="body",
        task_ids=(299,),
        resample=_iso(1.5),
        trainer="nnUNetTrainer",
        keep_largest_blob=True,
    ),
    "body_fast": TaskConfig(
        name="body_fast",
        task_ids=(300,),
        resample=_iso(6.0),
        trainer="nnUNetTrainer",
        keep_largest_blob=True,
    ),
    "pleural_pericard_effusion": TaskConfig(
        name="pleural_pericard_effusion",
        task_ids=(315,),
        resample=None,
        trainer="nnUNetTrainer",
        crop=(
            "lung_upper_lobe_left",
            "lung_lower_lobe_left",
            "lung_upper_lobe_right",
            "lung_middle_lobe_right",
            "lung_lower_lobe_right",
        ),
        crop_addon=(50, 50, 50),
        folds=None,
    ),
    "liver_vessels": TaskConfig(
        name="liver_vessels",
        task_ids=(8,),
        resample=None,
        trainer="nnUNetTrainer",
        crop=("liver",),
        crop_addon=(20, 20, 20),
    ),
    "liver_segments": TaskConfig(
        name="liver_segments",
        task_ids=(570,),
        resample=(0.8046879768371582, 0.8046879768371582, 1.5),
        trainer="nnUNetTrainerNoMirroring",
        crop=("liver",),
        crop_addon=(10, 10, 10),
    ),
    "heartchambers_highres": TaskConfig(
        name="heartchambers_highres",
        task_ids=(301,),
        resample=None,
        trainer="nnUNetTrainer",
        crop=("heart",),
        crop_addon=(5, 5, 5),
        remove_outside=("heart", "aorta", "inferior_vena_cava"),
        remove_outside_dilation_mm=10.0,
        license_required=True,
    ),
    "coronary_arteries": TaskConfig(
        name="coronary_arteries",
        task_ids=(507,),
        resample=(0.7, 0.7, 0.7),
        trainer="nnUNetTrainer_DASegOrd0_NoMirroring",
        model="3d_fullres_high",
        crop=("heart",),
        crop_addon=(20, 20, 20),
        license_required=True,
    ),
    # ---- remaining public python_api.py tasks (full registry parity) ----
    "total_mr": TaskConfig(
        name="total_mr", task_ids=(850, 851), resample=_iso(1.5),
        trainer="nnUNetTrainer_2000epochs_NoMirroring"),
    "total_mr_fast": TaskConfig(
        name="total_mr_fast", task_ids=(852,), resample=_iso(3.0),
        trainer="nnUNetTrainer_2000epochs_NoMirroring"),
    "total_mr_fastest": TaskConfig(
        name="total_mr_fastest", task_ids=(853,), resample=_iso(6.0),
        trainer="nnUNetTrainer_2000epochs_NoMirroring"),
    "total_highres_test": TaskConfig(
        name="total_highres_test", task_ids=(957,),
        resample=(0.75, 0.75, 1.0), trainer="nnUNetTrainerNoMirroring",
        model="3d_fullres_high"),
    "body_mr": TaskConfig(
        name="body_mr", task_ids=(597,), resample=_iso(1.5),
        trainer="nnUNetTrainer_DASegOrd0"),
    "body_mr_fast": TaskConfig(
        name="body_mr_fast", task_ids=(598,), resample=_iso(6.0),
        trainer="nnUNetTrainer_DASegOrd0"),
    "vertebrae_mr": TaskConfig(
        name="vertebrae_mr", task_ids=(756,), resample=_iso(1.5),
        trainer="nnUNetTrainer_DASegOrd0_NoMirroring"),
    "head_glands_cavities": TaskConfig(
        name="head_glands_cavities", task_ids=(775,),
        resample=(0.75, 0.75, 1.0),
        trainer="nnUNetTrainer_DASegOrd0_NoMirroring",
        model="3d_fullres_high", crop=("skull",), crop_addon=(10, 10, 10)),
    "headneck_bones_vessels": TaskConfig(
        name="headneck_bones_vessels", task_ids=(776,),
        resample=(0.75, 0.75, 1.0),
        trainer="nnUNetTrainer_DASegOrd0_NoMirroring",
        model="3d_fullres_high",
        crop=("clavicula_left", "clavicula_right", "vertebrae_C1",
              "vertebrae_C5", "vertebrae_T1", "vertebrae_T4"),
        crop_addon=(40, 40, 40)),
    "head_muscles": TaskConfig(
        name="head_muscles", task_ids=(777,), resample=(0.75, 0.75, 1.0),
        trainer="nnUNetTrainer_DASegOrd0_NoMirroring",
        model="3d_fullres_high", crop=("skull",), crop_addon=(10, 10, 10)),
    "headneck_muscles": TaskConfig(
        name="headneck_muscles", task_ids=(778, 779),
        resample=(0.75, 0.75, 1.0),
        trainer="nnUNetTrainer_DASegOrd0_NoMirroring",
        model="3d_fullres_high",
        crop=("clavicula_left", "clavicula_right", "vertebrae_C1",
              "vertebrae_C5", "vertebrae_T1", "vertebrae_T4"),
        crop_addon=(40, 40, 40)),
    "oculomotor_muscles": TaskConfig(
        name="oculomotor_muscles", task_ids=(351,),
        resample=(0.47251562774181366, 0.47251562774181366,
                  0.8500002026557922),
        trainer="nnUNetTrainer_DASegOrd0_NoMirroring",
        crop=("skull",), crop_addon=(20, 20, 20)),
    "lung_nodules": TaskConfig(
        name="lung_nodules", task_ids=(913,), resample=_iso(1.5),
        trainer="nnUNetTrainer_MOSAIC_1k_QuarterLR_NoMirroring",
        crop=("lung_upper_lobe_left", "lung_lower_lobe_left",
              "lung_upper_lobe_right", "lung_middle_lobe_right",
              "lung_lower_lobe_right"),
        crop_addon=(10, 10, 10)),
    "kidney_cysts": TaskConfig(
        name="kidney_cysts", task_ids=(789,), resample=_iso(1.5),
        trainer="nnUNetTrainer_DASegOrd0_NoMirroring",
        crop=("kidney_left", "kidney_right", "liver", "spleen", "colon"),
        crop_addon=(10, 10, 10)),
    "breasts": TaskConfig(
        name="breasts", task_ids=(527,), resample=_iso(1.5),
        trainer="nnUNetTrainer_DASegOrd0_NoMirroring"),
    "ventricle_parts": TaskConfig(
        name="ventricle_parts", task_ids=(552,),
        resample=(0.4384765625, 0.4345703125, 1.0),
        trainer="nnUNetTrainerNoMirroring",
        crop=("brain",), crop_addon=(0, 0, 0)),
    "liver_segments_mr": TaskConfig(
        name="liver_segments_mr", task_ids=(576,),
        resample=(1.1250001788139343, 1.1875, 3.0),
        trainer="nnUNetTrainer_DASegOrd0_NoMirroring",
        crop=("liver",), crop_addon=(10, 10, 10)),
    "craniofacial_structures": TaskConfig(
        name="craniofacial_structures", task_ids=(115,), resample=_iso(0.5),
        trainer="nnUNetTrainer_DASegOrd0_NoMirroring",
        crop=("skull",), crop_addon=(20, 20, 20)),
    "abdominal_muscles": TaskConfig(
        name="abdominal_muscles", task_ids=(952,),
        resample=(0.75, 0.75, 1.0),
        trainer="nnUNetTrainer_DASegOrd0_NoMirroring",
        model="3d_fullres_high", crop=("body_trunc",),
        crop_addon=(5, 5, 5)),
    "teeth": TaskConfig(
        name="teeth", task_ids=(113,), resample=_iso(0.5),
        trainer="nnUNetTrainer_onlyMirror01", model="3d_lowres_high",
        crop=("teeth_lower", "teeth_upper"), crop_addon=(10, 10, 10),
        crop_model="craniofacial_structures"),
    "trunk_cavities": TaskConfig(
        name="trunk_cavities", task_ids=(343,), resample=_iso(1.5),
        trainer="nnUNetTrainer"),
    "brain_aneurysm": TaskConfig(
        name="brain_aneurysm", task_ids=(615,),
        resample=(0.390625, 0.390625, 0.5000016391277313),
        trainer="nnUNetTrainerDiceTopK10Loss_2000epochs", folds=None),
    # ---- license-gated commercial models (show_license_info tasks) ----
    "vertebrae_body": TaskConfig(
        name="vertebrae_body", task_ids=(305,), resample=_iso(1.5),
        trainer="nnUNetTrainer_DASegOrd0", license_required=True),
    "appendicular_bones": TaskConfig(
        name="appendicular_bones", task_ids=(304,), resample=_iso(1.5),
        trainer="nnUNetTrainerNoMirroring", license_required=True),
    "appendicular_bones_mr": TaskConfig(
        name="appendicular_bones_mr", task_ids=(855,), resample=_iso(1.5),
        trainer="nnUNetTrainer_2000epochs_NoMirroring",
        license_required=True),
    "tissue_types": TaskConfig(
        name="tissue_types", task_ids=(481,), resample=_iso(1.5),
        trainer="nnUNetTrainer", license_required=True),
    "tissue_types_mr": TaskConfig(
        name="tissue_types_mr", task_ids=(925,), resample=_iso(1.5),
        trainer="nnUNetTrainer_DASegOrd0_NoMirroring",
        license_required=True),
    "tissue_4_types": TaskConfig(
        name="tissue_4_types", task_ids=(485,), resample=_iso(1.5),
        trainer="nnUNetTrainer", license_required=True),
    "face": TaskConfig(
        name="face", task_ids=(303,), resample=_iso(1.5),
        trainer="nnUNetTrainerNoMirroring", license_required=True),
    "face_mr": TaskConfig(
        name="face_mr", task_ids=(856,), resample=_iso(1.5),
        trainer="nnUNetTrainer_2000epochs_NoMirroring",
        license_required=True),
    "brain_structures": TaskConfig(
        name="brain_structures", task_ids=(409,), resample=(0.5, 0.5, 1.0),
        trainer="nnUNetTrainer_DASegOrd0", model="3d_fullres_high",
        crop=("brain",), crop_addon=(10, 10, 10), license_required=True),
    "thigh_shoulder_muscles": TaskConfig(
        name="thigh_shoulder_muscles", task_ids=(857,), resample=_iso(1.5),
        trainer="nnUNetTrainer_2000epochs_NoMirroring",
        license_required=True),
    "thigh_shoulder_muscles_mr": TaskConfig(
        name="thigh_shoulder_muscles_mr", task_ids=(857,),
        resample=_iso(1.5),
        trainer="nnUNetTrainer_2000epochs_NoMirroring",
        license_required=True),
    "aortic_sinuses": TaskConfig(
        name="aortic_sinuses", task_ids=(920,), resample=(0.7, 0.7, 0.7),
        trainer="nnUNetTrainer_DASegOrd0_NoMirroring",
        model="3d_fullres_high", crop=("heart",), crop_addon=(0, 0, 0),
        license_required=True),
}

# --- BCA tasks (body_composition_analysis/tasks.py:15-48) ---
BCA_TASKS: dict[str, TaskConfig] = {
    "body_parts": TaskConfig(
        name="body_parts",
        task_ids=(543,),
        resample=(0.0, 0.0, 5.0),  # thickness-only; in-plane preserved
        trainer="nnUNetTrainer_1500epochs_NoMirroring",
        folds=(0, 1, 2, 3, 4),
        resample_only_thickness=True,
    ),
    "body_regions": TaskConfig(
        name="body_regions",
        task_ids=(542,),
        resample=(0.0, 0.0, 5.0),
        trainer="nnUNetTrainerNoMirroring",
        folds=(0, 1, 2, 3, 4),
        resample_only_thickness=True,
    ),
}


_FAST_VARIANTS = {"total": "total_fast", "body": "body_fast",
                  "total_mr": "total_mr_fast", "body_mr": "body_mr_fast"}


def get_task(name: str, fast: bool = False) -> TaskConfig:
    if name in _FAST_VARIANTS:
        return TASKS[_FAST_VARIANTS[name] if fast else name]
    if name in TASKS:
        if fast:
            raise ValueError(f"task {name} does not support the fast option")
        return TASKS[name]
    if name in BCA_TASKS:
        cfg = BCA_TASKS[name]
        if fast:  # fast BCA = fold 0 only (infer/infer.py: fast -> folds=[0])
            return TaskConfig(**{**cfg.__dict__, "folds": (0,)})
        return cfg
    raise KeyError(f"unknown task {name!r}")


def resolve_task(name: str, fast: bool = False) -> TaskConfig:
    """The serving pipeline's task resolution: fast variants by kwarg for
    total/body (and any non-`_fast`-suffixed name); explicitly suffixed
    `*_fast`/`*_fastest` names resolve as-is. Shared by predict_image and
    the warmup tool so they can never compile for different tasks."""
    if name in ("total", "body") or not name.endswith(("_fast", "_fastest")):
        return get_task(name, fast=fast)
    return get_task(name)
