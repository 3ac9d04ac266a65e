"""Gradient-boosted-tree fitter emitting xgboost-format model documents.

Counterpart of `boa_tpu/compute/gbm.py`, numpy only: second-order boosting
with the xgboost gain formula and learned missing-value default directions
(binary:logistic), written as the JSON model documents that
`compute/xgb.py`'s TreeEnsemble scores, so training and serving share one
on-disk format. It fitted the vendored GIT-contrast folds
(`resources/git_contrast_classifiers_boa_tpu.json.*`); on the same data and
seed its trees and documents equal the reference's exactly.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class _Node:
    feature: int = 0
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    default_left: bool = True
    leaf_value: float = 0.0


def _best_split(x, g, h, idx, lam, min_child_weight):
    """(gain, feature, threshold, default_left, left_idx, right_idx).

    Vectorized exact greedy search: per feature, one sort + cumulative
    g/h sums score every distinct-value cut (and both missing-value
    default directions) in numpy."""
    G, H = g[idx].sum(), h[idx].sum()
    parent = G * G / (H + lam)
    best_gain, best = 0.0, None
    for j in range(x.shape[1]):
        col = x[idx, j]
        miss = np.isnan(col)
        pres = idx[~miss]
        if len(pres) < 2:
            continue
        Gm, Hm = g[idx[miss]].sum(), h[idx[miss]].sum()
        order = pres[np.argsort(x[pres, j], kind="stable")]
        vals = x[order, j]
        gc = np.cumsum(g[order])
        hc = np.cumsum(h[order])
        Gp, Hp = gc[-1], hc[-1]
        # candidate cut after position i (xgboost: value < threshold goes
        # left; thresholds are the NEXT distinct value so the cut lands
        # between values)
        cuts = np.nonzero(vals[1:] != vals[:-1])[0]
        if not len(cuts):
            continue
        gl, hl = gc[cuts], hc[cuts]
        gr, hr = Gp - gl, Hp - hl
        for dleft in (True, False):
            GL = gl + (Gm if dleft else 0.0)
            HL = hl + (Hm if dleft else 0.0)
            GR = gr + (0.0 if dleft else Gm)
            HR = hr + (0.0 if dleft else Hm)
            # xgboost gain = 1/2 (GL²/(HL+λ) + GR²/(HR+λ) − parent): the
            # 1/2 keeps the `gamma` pruning threshold on xgboost's scale
            gain = 0.5 * (GL * GL / (HL + lam) + GR * GR / (HR + lam)
                          - parent)
            gain[(HL < min_child_weight) | (HR < min_child_weight)] = -np.inf
            k = int(np.argmax(gain))
            if gain[k] > best_gain + 1e-12:
                best_gain = float(gain[k])
                best = (j, float(vals[cuts[k] + 1]), dleft, int(cuts[k]),
                        order)
    if best is None:
        return None
    j, thr, dleft, i, order = best
    left_idx = order[: i + 1]
    right_idx = order[i + 1:]
    miss_idx = idx[np.isnan(x[idx, j])]
    if dleft:
        left_idx = np.concatenate([left_idx, miss_idx])
    else:
        right_idx = np.concatenate([right_idx, miss_idx])
    return best_gain, j, thr, dleft, left_idx, right_idx


def _build_tree(x, g, h, lr, max_depth, lam, gamma, min_child_weight):
    nodes: list[_Node] = []

    def leaf(idx):
        w = -g[idx].sum() / (h[idx].sum() + lam) * lr
        nodes.append(_Node(leaf_value=float(w)))
        return len(nodes) - 1

    def grow(idx, depth):
        if depth >= max_depth or len(idx) < 2:
            return leaf(idx)
        found = _best_split(x, g, h, idx, lam, min_child_weight)
        if found is None or found[0] <= gamma:
            return leaf(idx)
        _, j, thr, dleft, li, ri = found
        me = len(nodes)
        nodes.append(_Node(feature=j, threshold=thr, default_left=dleft))
        nodes[me].left = grow(li, depth + 1)
        nodes[me].right = grow(ri, depth + 1)
        return me

    grow(np.arange(len(g)), 0)
    return nodes


def _nodes_to_tree_json(nodes: list[_Node]) -> dict:
    """xgboost JSON tree arrays (leaf weight in split_conditions)."""
    n = len(nodes)
    return {
        "split_indices": [nd.feature for nd in nodes],
        "split_conditions": [nd.leaf_value if nd.left == -1 else nd.threshold
                             for nd in nodes],
        "left_children": [nd.left for nd in nodes],
        "right_children": [nd.right for nd in nodes],
        "default_left": [1 if nd.default_left else 0 for nd in nodes],
        "categories": [],
        "id": 0,
        "tree_param": {"num_nodes": str(n), "num_feature": "0",
                       "size_leaf_vector": "1"},
    }


def fit_gbtree(x: np.ndarray, y: np.ndarray, *, n_rounds: int = 60,
               max_depth: int = 3, learning_rate: float = 0.3,
               reg_lambda: float = 1.0, gamma: float = 0.0,
               min_child_weight: float = 1e-3, base_score: float = 0.5,
               feature_names: list[str] | None = None,
               subsample: float = 1.0, seed: int = 0) -> dict:
    """Fit binary:logistic boosted trees; returns an xgboost model doc
    (decodable by `TreeEnsemble.from_model_doc` / `load_auto` as JSON).

    x: (N, F) float with NaN for missing; y: (N,) 0/1.
    """
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float64)
    rng = np.random.RandomState(seed)
    margin = np.full(len(y), np.log(base_score / (1 - base_score))
                     if 0 < base_score < 1 else 0.0)
    trees = []
    for _ in range(n_rounds):
        p = 1.0 / (1.0 + np.exp(-margin))
        g = p - y
        h = np.maximum(p * (1.0 - p), 1e-16)
        if subsample < 1.0:
            keep = rng.uniform(size=len(y)) < subsample
            gs, hs = np.where(keep, g, 0.0), np.where(keep, h, 1e-16)
        else:
            gs, hs = g, h
        nodes = _build_tree(x, gs, hs, learning_rate, max_depth,
                            reg_lambda, gamma, min_child_weight)
        trees.append(nodes)
        # update margins by walking the fresh tree
        for row in range(len(y)):
            node = 0
            while nodes[node].left != -1:
                v = x[row, nodes[node].feature]
                if np.isnan(v):
                    node = nodes[node].left if nodes[node].default_left \
                        else nodes[node].right
                elif v < nodes[node].threshold:
                    node = nodes[node].left
                else:
                    node = nodes[node].right
            margin[row] += nodes[node].leaf_value
    return {"learner": {
        "gradient_booster": {
            "name": "gbtree",
            "model": {"trees": [_nodes_to_tree_json(t) for t in trees],
                      "tree_info": [0] * len(trees),
                      "gbtree_model_param": {
                          "num_trees": str(len(trees)),
                          "num_parallel_tree": "1"}},
        },
        "learner_model_param": {"base_score": repr(float(base_score)),
                                "num_feature": str(x.shape[1]),
                                "num_class": "0"},
        "objective": {"name": "binary:logistic",
                      "reg_loss_param": {"scale_pos_weight": "1"}},
        "feature_names": feature_names or [],
        "feature_types": [],
    }, "version": [2, 0, 0]}


def save_model_doc(doc: dict, path: str | Path) -> None:
    Path(path).write_text(json.dumps(doc))
