"""The front `totalsegmentator`: the port's TotalSegmentator API,
`boa_tpu_torch.python_api.totalsegmentator(..., ml=True)`, one study a call
(the input's load, `predict_image` on the card, the write of
`total.nii.gz`), over a store in the TotalSegmentator layout
(`Dataset{id:03d}_{name}/{trainer}__nnUNetPlans__3d_fullres/`, the layout of
`boa_tpu_torch/weights/store.py:_write_store_entry`), and the reference's
judgement of what it wrote.

The reference's geometry of a study (`StudyGeometry`, frozen copies of the
API's in `reference/geometry.py`): the in-plane body crop, the canonical
orientation, the order-3 resample to the model grid, and the map from each
voxel of the written `total.nii.gz` back to the model-grid voxel its label
came from (the order-0 back-resample, the inverse orientation and the
pad-back). Every sub-model's logits are `reference/study.py:fused_logits`
with the family's forward.

For a task of several sub-models merged by the label table (later
sub-models over earlier ones), a written label of part k says that
sub-model k chose that label and every later sub-model chose background;
background says every sub-model chose background; the gap of the voxel is
the largest over those statements.
"""

from __future__ import annotations

import numpy as np
import torch

from boa_tpu_torch import python_api
from boa_tpu_torch.weights.store import ModelStore
from perfbench import weights
from perfbench.reference import geometry as geo
from perfbench.reference import nifti as ref_nifti
from perfbench.reference import study

output_name = "total.nii.gz"


def write_store(setup):
    """Every model of the configuration in the store layout under the run's
    work directory; returns the program's `ModelStore` of it."""
    cfg = setup.cfg
    arch = setup.family.arch(cfg["network"])
    root = setup.work / "store"
    for m, flat in zip(cfg["models"], setup.params):
        mdir = (root / f"Dataset{int(m['task_id']):03d}_{m['dataset']}"
                / f"{m['trainer']}__nnUNetPlans__3d_fullres")
        weights.write_model_folder(mdir, cfg, int(m["num_classes"]), arch, flat)
    return ModelStore(root=root)


def segment(setup, i: int, output, spans: dict | None = None) -> None:
    """Phantom `i` through the API into `output`; `spans` gets the program's
    spans and counters."""
    prog = setup.cfg["program"]
    python_api.totalsegmentator(setup.paths[i], output, ml=True, fast=prog["fast"],
                                task=prog["task"], quiet=True, store=setup.store,
                                device=setup.device.type, spans=spans)


def judge(setup, picked: list, trees: list, fp8: bool = False) -> dict:
    """The readings of the studies `picked` ((phantom index, output file)
    pairs): each study's voxel gaps, the label faults and the outputs
    missing. `trees`: each model's leaves on the device. `fp8=True` is the
    control: the labels are the reference's own in float8, merged and
    written as the program would write them, in place of the program's."""
    cfg, dev = setup.cfg, setup.device
    gaps, faults, missing = [], 0, 0
    for i, path in picked:
        labels = None
        if not fp8:
            if not path.exists():
                missing += 1
                continue
            labels, aff = ref_nifti.read(path)
            if (labels.shape != setup.cts[i].shape
                    or not np.allclose(aff, setup.affines[i], atol=1e-3)):
                faults += int(np.prod(setup.cts[i].shape))
                continue
        geom = StudyGeometry(setup.cts[i], setup.affines[i], cfg["spacing"], dev)

        def logits(k, low=False):
            return study.fused_logits(setup.family.forward, trees[k], cfg,
                                      int(cfg["models"][k]["num_classes"]), geom.volume,
                                      fp8=low)

        if fp8:
            low = [logits(k, True).argmax(0) for k in range(len(trees))]
            labels = written_labels(geom, merged_labels(cfg, low))
        j = Judge(labels, geom, cfg, dev)
        for k in range(len(trees)):
            j.add_model(k, logits(k))
        r = j.readings()
        gaps.append(r["gap"])
        faults += r["label_faults"]
        del j, geom
    return {"gaps": gaps, "label_faults": faults, "missing": missing}


class StudyGeometry:
    """The reference's geometry of one CT (orig int16 array + affine) for a
    configuration's grid."""

    def __init__(self, ct: np.ndarray, affine: np.ndarray, spacing, device):
        self.orig_shape = tuple(int(n) for n in ct.shape)
        zooms = tuple(float(np.linalg.norm(affine[:3, i])) for i in range(3))
        self.crop = geo.body_crop_xy(ct, zooms)
        if self.crop is None:
            x0, x1, y0, y1 = 0, ct.shape[0], 0, ct.shape[1]
            aff = affine
        else:
            x0, x1, y0, y1 = self.crop
            aff = np.array(affine, np.float64, copy=True)
            aff[:3, 3] = (aff @ np.array([x0, y0, 0.0, 1.0]))[:3]
        self.box = (x0, x1, y0, y1)
        cropped = ct[x0:x1, y0:y1]
        self.ornt, self.canon_shape, self.canon_zooms = geo.canonical_geometry(
            aff, cropped.shape)
        canon = geo.apply_orientation(torch.from_numpy(np.ascontiguousarray(cropped))
                                      .to(device), self.ornt)
        if np.allclose(self.canon_zooms, spacing):
            self.model_shape = self.canon_shape
            self.bwd = (None,) * 3
            self.volume = canon.to(torch.int32)
        else:
            self.model_shape, fwd, self.bwd = geo.resample_windows(
                self.crop, self.ornt, self.orig_shape, self.canon_shape,
                self.canon_zooms, spacing)
            # truncated toward zero, as the port's int32 cast
            self.volume = geo.resample_cubic(canon, self.model_shape, fwd).to(torch.int32)
        # model-grid index of each canonical voxel, per axis
        self.index = [torch.from_numpy(geo.axis_idx_windowed(
            self.model_shape[a], self.canon_shape[a], self.bwd[a])).to(device)
            for a in range(3)]


def part_tables(cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """(model index, model label) of each task label, from the configuration's
    `part_to_task` tables (one model: the identity, model 0)."""
    models = cfg["models"]
    if len(models) == 1:
        n = int(models[0]["num_classes"])
        kpart = np.zeros(n, np.int64)
        kpart[0] = -1
        return kpart, np.arange(n, dtype=np.int64)
    n = 1 + max(max(m["part_to_task"]) for m in models)
    kpart = np.full(n, -2, np.int64)   # -2: no such label
    plab = np.zeros(n, np.int64)
    kpart[0] = -1
    for k, m in enumerate(models):
        for pl, tl in enumerate(m["part_to_task"]):
            if pl:
                kpart[tl], plab[tl] = k, pl
    return kpart, plab


class Judge:
    """Accumulates the comparison of one study's written labels."""

    def __init__(self, labels: np.ndarray, geom: StudyGeometry, cfg: dict, device):
        x0, x1, y0, y1 = geom.box
        lab = torch.from_numpy(np.ascontiguousarray(labels)).to(device).long()
        inside = torch.zeros(lab.shape, dtype=torch.bool, device=device)
        inside[x0:x1, y0:y1] = True
        kpart, plab = part_tables(cfg)
        self.outside_nonzero = int(((lab != 0) & ~inside).sum())
        canon = geo.apply_orientation(lab[x0:x1, y0:y1], geom.ornt).contiguous()
        n = len(kpart)
        self.bad_labels = int(((canon < 0) | (canon >= n)).sum())
        canon = canon.clamp(0, n - 1)
        self.kpart = torch.from_numpy(kpart).to(device)[canon]
        self.plab = torch.from_numpy(plab).to(device)[canon]
        self.bad_labels += int((self.kpart == -2).sum())
        self.gap = torch.zeros(canon.shape, dtype=torch.float32, device=device)
        self.geom = geom

    def add_model(self, k: int, logits: torch.Tensor, slab: int = 16) -> None:
        """Fold in sub-model k's reference logits (classes, model grid)."""
        ix, iy, iz = self.geom.index
        best = logits.amax(dim=0)
        for a in range(0, self.gap.shape[0], slab):
            sl = slice(a, a + slab)
            kp, pl = self.kpart[sl], self.plab[sl]
            said = torch.where(kp == k, pl, torch.zeros_like(pl))
            bound = (kp <= k) & (kp != -2)
            rows = ix[sl]
            lg = logits[:, rows][:, :, iy][:, :, :, iz]
            chosen = torch.gather(lg, 0, said[None]).squeeze(0)
            b = best[rows][:, iy][:, :, iz]
            g = torch.where(bound, b - chosen, torch.zeros_like(chosen))
            self.gap[sl] = torch.maximum(self.gap[sl], g)

    def readings(self) -> dict:
        return {"gap": self.gap.flatten(), "label_faults": self.outside_nonzero + self.bad_labels}


def written_labels(geom: StudyGeometry, labels_model: torch.Tensor) -> np.ndarray:
    """What the program would write for model-grid labels: the order-0
    back-resample, the inverse orientation and the pad-back, on the input grid."""
    ix, iy, iz = geom.index
    canon = labels_model[ix][:, iy][:, :, iz]
    inv = np.zeros_like(geom.ornt)
    for i in range(3):
        inv[int(geom.ornt[i, 0]), 0] = i
        inv[int(geom.ornt[i, 0]), 1] = geom.ornt[i, 1]
    crop = geo.apply_orientation(canon, inv).cpu().numpy()
    out = np.zeros(geom.orig_shape, np.uint8)
    x0, x1, y0, y1 = geom.box
    out[x0:x1, y0:y1] = crop
    return out


def merged_labels(cfg: dict, per_model: list) -> torch.Tensor:
    """Task labels on the model grid from each sub-model's argmax labels,
    later sub-models over earlier ones (one model: its labels)."""
    models = cfg["models"]
    if len(models) == 1:
        return per_model[0]
    out = torch.zeros_like(per_model[0])
    for m, lab in zip(models, per_model):
        lut = torch.tensor(m["part_to_task"], device=lab.device)
        out = torch.where(lab > 0, lut[lab], out)
    return out
