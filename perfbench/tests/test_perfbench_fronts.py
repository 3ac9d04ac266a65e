"""A configuration's front door and network family, found by name.

(a) A throwaway root adds a second family (a PlainConvUNet with one conv a
decoder stage, with its own leaves, plans block and forward) and a second
front (the model-folder predictor, `engine/predict.py:predict_folder`, with
mirroring off) as new files only; the harness runs it on the CPU and the
run is correct. (b) The same front with its answer altered where it is
produced is not. (c) The TotalSegmentator front on the tiny configuration
reads what the benchmark read before fronts and families were split out:
the seeded leaves, the plans and the checked readings, pinned.
"""

import ast
import hashlib
import json
import time
from pathlib import Path

import numpy as np
import pytest

from perfbench import harness
from perfbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]

TOY_FAMILY = '''"""A PlainConvUNet with one conv a decoder stage."""

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.nets.plainconvunet import layers  # noqa: F401
from perfbench.reference import unet


def leaf_specs(net, num_classes):
    specs = []
    feats, ks, st = net["features_per_stage"], net["kernel_sizes"], net["strides"]

    def conv(path, k, cin, cout, norm=True):
        fan = cin * int(np.prod(k))
        specs.append((path + ("w",), tuple(k) + (cin, cout), math.sqrt(1.0 / fan)))
        specs.append((path + ("b",), (cout,), 1.0 / math.sqrt(fan)))
        if norm:
            specs.append((path + ("norm_scale",), (cout,), -1.0))
            specs.append((path + ("norm_bias",), (cout,), 0.0))

    cin = net["input_channels"]
    for s, f in enumerate(feats):
        for b in range(net["n_conv_per_stage"][s]):
            conv(("encoder", s, b), ks[s], cin, f)
            cin = f
    for i, s in enumerate(range(len(feats) - 1, 0, -1)):
        specs.append((("decoder", i, "transp", "w"), tuple(st[s]) + (feats[s - 1], feats[s]),
                      0.1))
        specs.append((("decoder", i, "transp", "b"), (feats[s - 1],), 0.1))
        conv(("decoder", i, "convs", 0), ks[s - 1], 2 * feats[s - 1], feats[s - 1])
        conv(("seg_heads", i), (1, 1, 1), feats[s - 1], num_classes, norm=False)
    return specs


def arch(net):
    keys = ("features_per_stage", "kernel_sizes", "strides", "n_conv_per_stage",
            "n_conv_per_stage_decoder")
    return {"network_class_name":
            "dynamic_network_architectures.architectures.unet.PlainConvUNet",
            "arch_kwargs": dict({k: net[k] for k in keys},
                                n_stages=len(net["features_per_stage"]), conv_bias=True,
                                norm_op_kwargs={"eps": net["norm_eps"], "affine": True},
                                nonlin_kwargs={"negative_slope": net["nonlin_slope"]})}


@torch.no_grad()
def forward(params, net, x, fp8=False):
    eps, slope, st = net["norm_eps"], net["nonlin_slope"], net["strides"]
    skips, h = [], x.float()
    for s, stage in enumerate(params["encoder"]):
        for b, p in enumerate(stage):
            h = unet.conv_block(h, p, st[s] if b == 0 else (1, 1, 1), eps, slope, fp8)
        skips.append(h)
    h = skips.pop()
    for d in params["decoder"]:
        w = unet.transp_weight(d["transp"]["w"])
        if fp8:
            h, w = unet.round_e4m3(h), unet.round_e4m3(w)
        h = F.conv_transpose3d(h, w, d["transp"]["b"], stride=tuple(w.shape[2:]))
        h = unet.conv_block(torch.cat([h, skips.pop()], 1), d["convs"][0], (1, 1, 1),
                            eps, slope, fp8)
    head = params["seg_heads"][-1]
    w = unet.conv_weight(head["w"])
    if fp8:
        h, w = unet.round_e4m3(h), unet.round_e4m3(w)
    return F.conv3d(h, w, head["b"])
'''

TOY_FRONT = '''"""nnU-Net's model-folder predictor on one case a call, mirroring off."""

import numpy as np
import torch

from boa_tpu_torch.engine.predict import predict_folder
from perfbench import weights
from perfbench.reference import nifti as ref_nifti
from perfbench.reference import study

output_name = "case.nii.gz"


def write_store(setup):
    m = setup.cfg["models"][0]
    mdir = setup.work / "model" / f"{m['trainer']}__nnUNetPlans__3d_fullres"
    weights.write_model_folder(mdir, setup.cfg, int(m["num_classes"]),
                               setup.family.arch(setup.cfg["network"]), setup.params[0])
    return mdir


def segment(setup, i, output, spans=None):
    case = setup.work / "cases" / str(i)
    if not case.is_dir():
        case.mkdir(parents=True)
        (case / "case.nii").symlink_to(setup.paths[i])
    predict_folder(case, output.parent, model_dir=setup.store, folds=[0],
                   step_size=setup.cfg["step_size"], disable_tta=True,
                   device=setup.device, spans=spans)


def judge(setup, picked, trees, fp8=False):
    n = int(setup.cfg["models"][0]["num_classes"])
    gaps, faults, missing = [], 0, 0
    for i, path in picked:
        vol = torch.from_numpy(setup.cts[i].astype(np.int32)).to(setup.device)
        logits = study.fused_logits(setup.family.forward, trees[0], setup.cfg, n, vol)
        if fp8:
            labels = study.fused_logits(setup.family.forward, trees[0], setup.cfg, n, vol,
                                        fp8=True).argmax(0)
        elif not path.exists():
            missing += 1
            continue
        else:
            labels = torch.from_numpy(ref_nifti.read(path)[0].astype(np.int64))
        faults += int((labels >= n).sum())
        labels = labels.clamp(max=n - 1).to(logits.device)
        gaps.append((logits.amax(0) - logits.gather(0, labels[None])[0]).flatten())
    return {"gaps": gaps, "label_faults": faults, "missing": missing}
'''


def _toy_root(tmp_path: Path) -> Path:
    cfg = tiny.config()
    cfg.update(name="toy", program={"front": "modelfolder"},
               network=dict(tiny.NET, family="ToyUNet", n_conv_per_stage_decoder=[1, 1]))
    cfg["models"] = [dict(cfg["models"][0], trainer="nnUNetTrainer")]
    mix = tiny.traffic(name="toymix", check_studies=2, phantoms=[
        {"shape": [48, 40, 24], "spacing": [3.0, 3.0, 3.0]},
        {"shape": [32, 56, 20], "spacing": [3.0, 3.0, 3.0]}])
    root = tiny.make_root(tmp_path, cfg=cfg, mix=mix)
    (root / "perfbench/nets").mkdir()
    (root / "perfbench/fronts").mkdir()
    (root / "perfbench/nets/toyunet.py").write_text(TOY_FAMILY)
    (root / "perfbench/fronts/modelfolder.py").write_text(TOY_FRONT)
    return root


def _run(root):
    return harness.run_cell(root, "tiny.mix", 2 ** 31 + 23, 1.0, False, "cpu",
                            time.perf_counter())


def test_a_new_front_and_family_as_files(tmp_path):
    r = _run(_toy_root(tmp_path))
    assert r["correct"], r["checks"]
    assert r["checked"]["studies"] == 2 and r["checked"]["voxels"] == 48 * 40 * 24 + 32 * 56 * 20


def test_the_new_front_altered_is_not_correct(tmp_path, monkeypatch):
    from boa_tpu_torch.inference import predictor

    orig = predictor.sliding_window_seg_chunked

    def altered(*a, **kw):
        seg = orig(*a, **kw)
        n = int(a[4])
        half = seg.shape[0] // 2
        seg[:half] = ((seg[:half].long() + 1) % n).to(seg.dtype)
        return seg

    monkeypatch.setattr(predictor, "sliding_window_seg_chunked", altered)
    r = _run(_toy_root(tmp_path))
    assert not r["correct"]
    assert r["checks"]["gap_p999"]["value"] > r["checks"]["gap_p999"]["limit"]


# What the tiny TotalSegmentator cell read at seed 4242, two checked
# studies, before the front and the family were split out of the harness.
PINNED_LEAVES = "ea2d87e969275147d26362b289f90bc767bf8aa46330c67d82536a576c027fb8"
PINNED_PLANS = "8853d4d55e614357052e8f1fb5f2cc7f84a664a91a86f7407205af5b9329be56"
PINNED_CHECKED = {"studies": 2, "voxels": 557056, "gap_max": 0.023857712745666504,
                  "gap_p999": 0.006722301244735718, "gap_mean": 2.645698524408063e-05,
                  "flip_share": 0.008090748506433824, "flip_gap_mean": 0.003270029370340932}
# operations of one tile forward of ts_total, the mean over its five parts
PINNED_TILE_FLOPS = 957469635379.2


def test_totalsegmentator_reads_as_before(tmp_path):
    root = tiny.make_root(tmp_path / "root", mix=tiny.traffic(check_studies=2))
    (tmp_path / "w").mkdir()
    s = harness.Setup(root, "tiny.mix", 4242, "cpu", tmp_path / "w")
    h = hashlib.sha256()
    for flat in s.params:
        for k in flat:
            h.update(k.encode())
            h.update(np.ascontiguousarray(flat[k]).tobytes())
    assert h.hexdigest() == PINNED_LEAVES
    plans = next((tmp_path / "w/store").rglob("plans.json")).read_bytes()
    assert hashlib.sha256(plans).hexdigest() == PINNED_PLANS
    r = harness.run_cell(root, "tiny.mix", 4242, 1.0, False, "cpu", time.perf_counter())
    assert r["checks"]["label_faults"]["value"] == 0
    for k, v in PINNED_CHECKED.items():
        assert r["checked"][k] == pytest.approx(v, rel=1e-4, abs=0), k


def test_tile_operations_of_ts_total():
    cfg = json.loads((REPO / "perfbench/configs/ts_total.json").read_text())
    family = harness.find(REPO, "nets", cfg["network"]["family"].lower())
    art = {"config": cfg, "family": family, "trace": {"window_s": 1.0},
           "spans": [{"tile_forwards": 1}]}
    mfu = harness.metric_reader("mfu.study")(art)
    assert mfu * 989e12 / 100.0 == pytest.approx(PINNED_TILE_FLOPS, rel=1e-12)


GENERIC = ["harness.py", "weights.py", "control.py", "work/roofline.py",
           *[f"metrics/{p.name}" for p in (REPO / "perfbench/metrics").glob("*.py")]]
SPECIFIC = ("totalsegmentator", "python_api", "plainconvunet", "seg_heads", "encoder",
            "decoder")


@pytest.mark.parametrize("name", GENERIC)
def test_generic_modules_name_no_front_or_family(name):
    """Names, imports and strings in code (docstrings aside) of the modules
    that every front and family share."""
    tree = ast.parse((REPO / "perfbench" / name).read_text())
    docs = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)}
    words = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Name):
            words.append(n.id)
        elif isinstance(n, ast.Attribute):
            words.append(n.attr)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            words += [getattr(n, "module", None) or ""] + [a.name for a in n.names]
        elif isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs:
            words.append(n.value)
    assert not [w for w in words if any(x in w.lower() for x in SPECIFIC)]
