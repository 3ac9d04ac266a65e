"""Model-engine tools of the port: folder prediction (`predict.py`),
ensembling and postprocessing determination (`ensembling.py`), evaluation
(`evaluation.py`) and the dataset fingerprint (`fingerprint.py`), the
counterparts of nnUNetv2_predict, _ensemble, _find_best_configuration and
_evaluate_folder. The planner waits for the port's trainer (ROADMAP M11)."""

from boa_tpu_torch.engine.ensembling import (  # noqa: F401
    apply_postprocessing,
    determine_postprocessing,
    ensemble_probabilities,
    ensemble_segmentations,
    find_best_configuration,
)
from boa_tpu_torch.engine.evaluation import evaluate_folder_arrays  # noqa: F401
from boa_tpu_torch.engine.fingerprint import extract_fingerprint  # noqa: F401
