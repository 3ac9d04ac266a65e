"""Pure-numpy scorer for XGBoost gradient-boosted-tree models.

Counterpart of `boa_tpu/compute/xgb.py`: loads the model documents the
contrast classifiers ship as data (UBJSON or JSON fold files, and the
pickled XGBRegressor folds of `resources/contrast_phase_classifiers_2024_07_19.pkl`,
TotalSegmentator `bin/totalseg_get_phase.py:57-120`) without the xgboost
package, and walks the trees. Objectives: binary:logistic (sigmoid link),
the identity-link regressors and multi:softprob/softmax (per-class tree
groups via tree_info, softmax link). Categorical splits raise.
"""

from __future__ import annotations

import math
import pickle
from pathlib import Path
from typing import Any

import numpy as np

from boa_tpu_torch.io import ubjson


class TreeEnsemble:
    """One boosted ensemble (a single XGBoost learner)."""

    def __init__(self, trees: list[dict], objective: str, base_score: float,
                 num_features: int, feature_names: list[str] | None = None,
                 num_class: int = 0, tree_info: list[int] | None = None):
        if any(len(t["categories"]) for t in trees):
            raise ValueError("categorical splits are not supported")
        self.objective = objective
        self.base_score = base_score
        self.num_features = num_features
        self.feature_names = feature_names
        # multiclass: tree_info[i] is the class tree i boosts (trees are
        # interleaved round-robin per boosting iteration)
        self.num_class = int(num_class)
        if self.num_class >= 2:
            if tree_info is None:
                raise ValueError("multiclass model without tree_info")
            self.tree_info = [int(c) for c in tree_info]
        else:
            self.tree_info = [0] * len(trees)
        self._split_index = [np.asarray(t["split_indices"]) for t in trees]
        self._split_cond = [np.asarray(t["split_conditions"], np.float32)
                           for t in trees]
        self._left = [np.asarray(t["left_children"]) for t in trees]
        self._right = [np.asarray(t["right_children"]) for t in trees]
        self._default_left = [np.asarray(t["default_left"], bool)
                              for t in trees]

    # -- construction -----------------------------------------------------
    @classmethod
    def from_model_doc(cls, doc: dict) -> "TreeEnsemble":
        learner = doc["learner"]
        booster = learner["gradient_booster"]
        if booster.get("name", "gbtree") != "gbtree":
            raise ValueError(f"unsupported booster {booster.get('name')!r}")
        param = learner["learner_model_param"]
        num_class = int(param.get("num_class", "0") or 0)
        objective = learner["objective"]["name"]
        if objective.startswith("multi:") and num_class < 2:
            raise ValueError("multi:* objective without num_class")
        tree_info = booster["model"].get("tree_info")
        if tree_info is not None:
            tree_info = list(np.asarray(tree_info).tolist())
        return cls(
            trees=booster["model"]["trees"],
            objective=objective,
            base_score=float(param["base_score"]),
            num_features=int(param["num_feature"]),
            feature_names=learner.get("feature_names") or None,
            num_class=num_class,
            tree_info=tree_info,
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "TreeEnsemble":
        return cls.from_model_doc(ubjson.load_auto(data))

    @classmethod
    def from_file(cls, path: str | Path) -> "TreeEnsemble":
        return cls.from_bytes(Path(path).read_bytes())

    # -- scoring ----------------------------------------------------------
    def _base_margin(self) -> float:
        if self.objective.startswith("binary:"):
            p = min(max(self.base_score, 1e-7), 1 - 1e-7)
            return math.log(p / (1.0 - p))
        return self.base_score

    def _tree_leaf(self, t: int, sample: np.ndarray) -> float:
        fidx, cond = self._split_index[t], self._split_cond[t]
        left, right = self._left[t], self._right[t]
        dleft = self._default_left[t]
        node = 0
        while left[node] != -1:
            value = sample[fidx[node]]
            if np.isnan(value):
                # missing values follow the tree's learned default branch
                node = left[node] if dleft[node] else right[node]
            elif value < cond[node]:  # strictly-less goes left; ties right
                node = left[node]
            else:
                node = right[node]
        # leaf weight lives in split_conditions at leaf nodes
        return float(cond[node])

    def predict_margin(self, features: np.ndarray) -> np.ndarray:
        """Raw margin for an (N, F) feature matrix — shape (N,), or
        (N, num_class) for multiclass models (per-class tree groups;
        base_score enters each class margin untransformed)."""
        x = np.atleast_2d(np.asarray(features, np.float32))
        n = x.shape[0]
        if self.num_class >= 2:
            out = np.full((n, self.num_class), self.base_score, np.float64)
            for row in range(n):
                for t, cls_id in enumerate(self.tree_info):
                    out[row, cls_id] += self._tree_leaf(t, x[row])
            return out
        out = np.full(n, self._base_margin(), np.float64)
        for row in range(n):
            out[row] += sum(self._tree_leaf(t, x[row])
                            for t in range(len(self._left)))
        return out

    def predict(self, features: np.ndarray) -> np.ndarray:
        """Transformed prediction: probability for binary:logistic,
        (N, K) softmax probabilities for multi:softprob/softmax, value
        for regression; class labels via `predict_label`."""
        margin = self.predict_margin(features)
        if self.num_class >= 2:
            e = np.exp(margin - margin.max(axis=1, keepdims=True))
            return e / e.sum(axis=1, keepdims=True)
        if self.objective.startswith("binary:"):
            return 1.0 / (1.0 + np.exp(-margin))
        return margin

    def predict_label(self, features: np.ndarray) -> np.ndarray:
        if self.num_class >= 2:
            return np.argmax(self.predict_margin(features), axis=1)
        if not self.objective.startswith("binary:"):
            raise ValueError("labels only defined for binary objectives")
        return (self.predict(features) > 0.5).astype(np.int64)


# -- loading pickled xgboost sklearn wrappers without xgboost --------------

class _StubBase:
    """Placeholder standing in for any pickled xgboost class: records the
    pickled state so the raw Booster bytes can be recovered."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


class _XGBUnpickler(pickle.Unpickler):
    _made: dict[tuple[str, str], type] = {}

    def find_class(self, module: str, name: str):
        if module == "xgboost" or module.startswith("xgboost."):
            key = (module, name)
            if key not in self._made:
                self._made[key] = type(name, (_StubBase,),
                                       {"__module__": module})
            return self._made[key]
        return super().find_class(module, name)


def _booster_bytes(obj: Any) -> bytes | None:
    """Raw UBJSON model bytes from a stub-unpickled XGB estimator."""
    booster = getattr(obj, "_Booster", None) or obj
    handle = getattr(booster, "handle", None)
    if isinstance(handle, (bytes, bytearray, memoryview)):
        return bytes(handle)
    return None


def load_pickled_ensembles(path: str | Path) -> dict[Any, TreeEnsemble]:
    """{fold_key: TreeEnsemble} from a pickled dict/list of XGB models.

    The xgboost sklearn wrappers pickle their Booster as the raw model
    document, so the trees are recoverable as pure data.
    """
    with open(path, "rb") as fh:
        raw = _XGBUnpickler(fh).load()
    items = raw.items() if isinstance(raw, dict) else enumerate(raw)
    out = {}
    for key, est in items:
        blob = _booster_bytes(est)
        if blob is None:
            raise ValueError(f"entry {key!r} has no recoverable booster")
        doc = ubjson.load_auto(blob)
        if "learner" not in doc:  # booster blobs may nest under "Model"
            doc = doc.get("Model", doc)
        out[key] = TreeEnsemble.from_model_doc(doc)
    return out


def load_fold_files(stem: str | Path, n_folds: int = 5) -> list[TreeEnsemble]:
    """[TreeEnsemble] from `<stem>.0 … <stem>.{n-1}` fold files."""
    models = []
    for fold in range(n_folds):
        p = Path(f"{stem}.{fold}")
        if not p.exists():
            break
        models.append(TreeEnsemble.from_file(p))
    if not models:
        raise FileNotFoundError(f"no fold files found at {stem}.*")
    return models
