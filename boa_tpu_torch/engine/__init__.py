"""Model-engine tools of the port: folder prediction (`predict.py`),
ensembling and postprocessing determination (`ensembling.py`), evaluation
(`evaluation.py`), the dataset fingerprint (`fingerprint.py`), the planner
(`planner.py`), preprocessing (`plan_and_preprocess.py`) and dataset
conversion (`dataset_conversion.py`), the counterparts of nnUNetv2_predict,
_ensemble, _find_best_configuration, _evaluate_folder,
_plan_and_preprocess and _convert_MSD_dataset; and the training benchmark
(`benchmark.py`, nnU-Net's nnUNetTrainerBenchmark_5epochs)."""

from boa_tpu_torch.engine.ensembling import (  # noqa: F401
    apply_postprocessing,
    determine_postprocessing,
    ensemble_probabilities,
    ensemble_segmentations,
    find_best_configuration,
)
from boa_tpu_torch.engine.evaluation import evaluate_folder_arrays  # noqa: F401
from boa_tpu_torch.engine.fingerprint import extract_fingerprint  # noqa: F401
