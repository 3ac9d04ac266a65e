#!/usr/bin/env python3
"""Smoke run of the PyTorch port (boa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the CUDA kernels from boa_tpu_torch/csrc (nvcc, sm_90a), then:

1. device   - the card's name and power limit, torch/CUDA versions, build time
2. kernels  - every kernel of the main path against its plain PyTorch version
              at the shapes a 128^3 total_fast tile gives it (bf16 outputs
              at rtol = atol = 2e-2, per-channel sums within 1e-2 of the
              largest sum of squares). K2 reads and K3 (with its bias) writes
              a channel slice of the (1, 128, 128, 128, 64) decoder concat,
              as the main path runs them; the channels K3 does not own must
              keep their bits. CUDA-event times of the kernel's launch alone
              (`kernel_ms`: weights packed and buffers allocated beforehand),
              the public wrapper (`wrapper_ms`), the plain version and the
              closest single PyTorch library call
3. forward  - the full-width total_fast U-Net on one 128^3 tile: the kernel
              composite against the same composite on the plain versions
              (argmax agreement > 0.99), and the time per tile
4. fused    - the wide-channel conv kernel (K5) against its plain version at
              each of the 17 convs of the fused forward (same bars and
              timings as phase 2; `kernel_ms` is the call with the weights
              packed beforehand, as the fused forward makes it), then the
              full-width fused forward on the same tile and model as phase
              3: argmax agreement > 0.99 with the same forward on the plain
              K5 and > 0.98 with the eager forward, exactly 17 K5 launches,
              and its time per tile beside the composite's and the eager
              forward's
5. study    - a small study through predict_image on the card against the
              same call on the CPU (labels agree > 0.99), then the
              512x512x300 fast-total study (one warm-up, three timed runs)
              with per-stage spans, peak memory and the kernel launch
              counts, which must equal tiles x (4, 1, 1) on every run, with
              no K5 launch

With --profile, the fused and study phases each add one more run under
torch.profiler (device busy share, kernels by device time). Each phase
prints one JSON line. Then come the kernel summary line
{"kernels": [...]} and, last, {"ok": true, "device": {...}}. Any failed
check raises, so the script exits non-zero without that last line; it also
exits non-zero when CUDA is unavailable or the package is missing.
Weights are random, drawn from fixed seeds.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core peak, same source
TOTAL_FAST_FEATURES = (32, 64, 128, 256, 320, 320)
REPLACES = {
    "conv3d_rows": "boa_tpu/ops/rowconv.py:78, boa_tpu/ops/rowconv.py:334",
    "conv3d_rows_stride2": "boa_tpu/ops/rowconv.py:426",
    "transpconv2_rows": "boa_tpu/ops/rowconv.py:620",
    "conv3d_in_act": "boa_tpu/ops/pallas_conv.py:100",
}
SOURCES = {
    "conv3d_rows": "boa_tpu_torch/csrc/rowconv.cu",
    "conv3d_rows_stride2": "boa_tpu_torch/csrc/stride2conv.cu",
    "transpconv2_rows": "boa_tpu_torch/csrc/transpconv.cu",
    "conv3d_in_act": "boa_tpu_torch/csrc/conv_in_act.cu",
}
# the 17 K5 calls of one fused total_fast forward on a 128^3 tile:
# (extent, cin, cout, whether a norm is pending on the input). The network
# input, the conv after each stride-2 block and the decoder concats arrive
# materialized (identity norm, slope 1); the others carry the previous
# conv's instance norm (slope 0.01).
FUSED_CONVS = [
    (128, 1, 32, False), (128, 32, 32, True),
    (64, 64, 64, False), (32, 128, 128, False), (16, 256, 256, False),
    (8, 320, 320, False), (4, 320, 320, False),
    (8, 640, 320, False), (8, 320, 320, True),
    (16, 512, 256, False), (16, 256, 256, True),
    (32, 256, 128, False), (32, 128, 128, True),
    (64, 128, 64, False), (64, 64, 64, True),
    (128, 64, 32, False), (128, 32, 32, True),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple[float, float]:
    """(ms moving the bytes at the memory rate, ms doing the operations at
    the bf16 tensor-core peak)."""
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3


# ---------------------------------------------------------------------------


def phase_device(torch, _build) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    regs, spills = {}, {}
    for stem, log in _build.build_info["logs"].items():
        lines = log.splitlines()
        regs[stem] = sorted({int(line.split("Used ")[1].split()[0])
                             for line in lines if "registers" in line})
        spills[stem] = max((int(line.split("bytes spill stores")[0].split(",")[-1])
                            for line in lines if "bytes spill stores" in line), default=0)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0, "build_cached": _build.build_info["cached"],
          "registers_per_thread": regs, "max_spill_store_bytes": spills})
    return {"smi": smi}


def _norm(torch, ops, rng, n, cin, dev):
    return ops.NormAct(
        mean=torch.tensor(rng.normal(size=(n, cin)) * 0.1, dtype=torch.float32, device=dev),
        inv_std=torch.tensor(1.0 + rng.random((n, cin)), dtype=torch.float32, device=dev),
        gamma=torch.tensor(1.0 + 0.1 * rng.normal(size=cin), dtype=torch.float32, device=dev),
        beta=torch.tensor(0.1 * rng.normal(size=cin), dtype=torch.float32, device=dev),
        slope=0.01)


def _bits(torch, t):
    return t.contiguous().view(torch.int16)


def phase_kernels(torch, rc) -> list[dict]:
    """Each kernel at the main path's shapes against its plain version.

    `kernel_ms` times the launch alone (`rc.prepare_launch`: weights packed,
    norm rows and outputs allocated outside the timed function);
    `wrapper_ms` the public call, which packs the weights on every call."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    # (kernel, n, spatial, cin, cout, slope kind, layout); the four
    # conv3d_rows calls of one tile are 1->32, 32->32 (stage 0) and 64->32,
    # 32->32 (decoder). Layout "concat" is the main path's: K2 reads and K3
    # (with its bias) writes a 32-channel slice of the (1, 128, 128, 128, 64)
    # decoder concat; "dense" cases take and give whole tensors.
    cases = [
        ("conv3d_rows", 1, 128, 1, 32, "none", "dense"),
        ("conv3d_rows", 1, 128, 32, 32, "scalar", "dense"),
        ("conv3d_rows", 1, 128, 64, 32, "vector", "dense"),
        ("conv3d_rows", 2, 128, 1, 32, "none", "dense"),
        ("conv3d_rows", 2, 128, 32, 32, "scalar", "dense"),
        ("conv3d_rows", 2, 128, 64, 32, "vector", "dense"),
        ("conv3d_rows_stride2", 1, 128, 32, 64, "scalar", "dense"),
        ("conv3d_rows_stride2", 1, 128, 32, 64, "scalar", "concat"),
        ("transpconv2_rows", 1, 64, 64, 32, None, "dense"),
        ("transpconv2_rows", 1, 64, 64, 32, None, "concat"),
    ]
    out = []
    for name, n, s, cin, cout, slope_kind, layout in cases:
        shape = (n, s, s, s, cin)
        x = torch.tensor(rng.normal(size=shape), dtype=torch.bfloat16, device=dev)
        sentinel_ok = None
        if name == "transpconv2_rows":
            w = torch.tensor(rng.normal(size=(2, 2, 2, cin, cout)) * 0.1,
                             dtype=torch.bfloat16, device=dev)
            b = None
            kw = {}
            if layout == "concat":
                b = torch.tensor(rng.normal(size=cout), dtype=torch.bfloat16, device=dev)
                cat = torch.full((n, 2 * s, 2 * s, 2 * s, 2 * cout), 7.0,
                                 dtype=torch.bfloat16, device=dev)
                kw["out"] = cat[..., :cout]
            launch, y = rc.prepare_launch(name, x, w, b, **kw)
            wrapper = lambda: rc.transpconv2_rows(x, w, b, **kw)  # noqa: E731
            plain = lambda: rc.transpconv2_rows_plain(x, w, b)  # noqa: E731
            wt = w.permute(3, 4, 0, 1, 2).contiguous()  # (ci, co, kx, ky, kz)
            lib = lambda: F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), wt, b,  # noqa: E731
                                             stride=2)
            launch()
            torch.cuda.synchronize()
            yr = plain()
            err = float((y.float() - yr.float()).abs().max())
            ok = bool(torch.allclose(y.float(), yr.float(), rtol=2e-2, atol=2e-2))
            if layout == "concat":   # the channels K3 does not own are untouched
                sentinel_ok = bool(torch.equal(
                    _bits(torch, cat[..., cout:]),
                    _bits(torch, torch.full_like(cat[..., cout:], 7.0))))
                ok = ok and sentinel_ok
            rel_sums = None
            vox_out = n * (2 * s) ** 3
            nbytes = (x.numel() * 2 + w.numel() * 2 + (cout * 2 if b is not None else 0)
                      + vox_out * cout * 2)
            flops = 2.0 * n * s ** 3 * cin * 8 * cout
        else:
            stride = 2 if name == "conv3d_rows_stride2" else 1
            w = torch.tensor(rng.normal(size=(3, 3, 3, cin, cout)) * (1.0 / (27 * cin) ** 0.5),
                             dtype=torch.bfloat16, device=dev)
            b = torch.tensor(rng.normal(size=cout) * 0.1, dtype=torch.bfloat16, device=dev)
            if slope_kind == "none":
                norm, slope = rc.identity_normact(cin, dev), 1.0
            else:
                norm = _norm(torch, rc, rng, n, cin, dev)
                slope = (torch.cat([torch.ones(cin // 2, device=dev),
                                    torch.full((cin - cin // 2,), 0.01, device=dev)])
                         if slope_kind == "vector" else 0.01)
            xk = x
            if layout == "concat":   # x lives in the concat's last cin channels
                cat = torch.tensor(rng.normal(size=shape[:4] + (2 * cin,)),
                                   dtype=torch.bfloat16, device=dev)
                cat[..., cin:] = x
                xk = cat[..., cin:]
            fn = rc.conv3d_rows if stride == 1 else rc.conv3d_rows_stride2
            pfn = rc.conv3d_rows_plain if stride == 1 else rc.conv3d_rows_stride2_plain
            launch, (y, sums) = rc.prepare_launch(name, xk, norm, w, b, slope=slope)
            wrapper = lambda: fn(xk, norm, w, b, slope=slope)  # noqa: E731
            plain = lambda: pfn(xk, norm, w, b, slope=slope)  # noqa: E731
            wt = w.permute(4, 3, 0, 1, 2).contiguous()
            lib = lambda: F.conv3d(x.permute(0, 4, 1, 2, 3), wt, b,  # noqa: E731
                                   stride=stride, padding=1)
            launch()
            torch.cuda.synchronize()
            yr, sr = plain()
            err = float((y.float() - yr.float()).abs().max())
            rel_sums = float((sums - sr).abs().max() / sr[:, 1].abs().max())
            ok = bool(torch.allclose(y.float(), yr.float(), rtol=2e-2, atol=2e-2)) \
                and rel_sums <= 1e-2
            so = s // stride
            nbytes = (x.numel() * 2 + w.numel() * 2 + cout * 2 + n * 4 * cin * 4
                      + n * so ** 3 * cout * 2 + n * 2 * cout * 4)
            flops = 2.0 * n * so ** 3 * 27 * cin * cout
        torch.cuda.synchronize()
        bytes_ms, ops_ms = bound(nbytes, flops)
        case = {"name": name, "n": n, "spatial": s, "cin": cin, "cout": cout,
                "slope": slope_kind, "layout": layout, "max_abs_err": err,
                "rel_err_sums": rel_sums, "sentinel_untouched": sentinel_ok,
                "kernel_ms": time_ms(torch, launch, 20),
                "wrapper_ms": time_ms(torch, wrapper, 10),
                "plain_ms": time_ms(torch, plain, 3),
                "library_ms": time_ms(torch, lib, 10),
                "bytes_ms": bytes_ms, "ops_ms": ops_ms, "ok": ok}
        out.append(case)
        del x, w, y, launch
        cat = xk = kw = None
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "cases": out})
    bad = [c for c in out if not c["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    return out


def _total_fast_model(torch, seed: int, head_bias: bool):
    from boa_tpu_torch.plans.plans import synthetic_plans
    from boa_tpu_torch.weights.convert import params_from_numpy
    from boa_tpu_torch.weights.store import init_params_numpy

    cfg = synthetic_plans(num_classes=118, patch_size=(128, 128, 128),
                          features=TOTAL_FAST_FEATURES).arch_config()
    params = init_params_numpy(cfg, seed)
    if head_bias:
        head = params["seg_heads"][-1]
        head["b"] = head["b"] + np.random.default_rng(7).normal(
            0, 3.0, head["b"].shape).astype(np.float32)
    return params_from_numpy(params, cfg, "cuda")


def phase_forward(torch, rc) -> dict:
    from boa_tpu_torch.models.unet import cast_model

    res = {}
    x = torch.tensor(np.random.default_rng(3).normal(size=(1, 128, 128, 128, 1)),
                     dtype=torch.bfloat16, device="cuda")
    with torch.no_grad():
        for label, head_bias in (("head_bias", True), ("plain_init", False)):
            model = cast_model(_total_fast_model(torch, 297, head_bias), torch.bfloat16)
            got = model(x, rc.KERNELS).float()
            ref = model(x, rc.PLAIN).float()
            assert got.shape == (1, 128, 128, 128, 118) and bool(torch.isfinite(got).all())
            res[label] = {
                "argmax_agree": float((got.argmax(-1) == ref.argmax(-1)).float().mean()),
                "max_abs_err": float((got - ref).abs().max()),
                "logit_absmax": float(ref.abs().max())}
            if head_bias:
                res["ms_per_tile_kernels"] = time_ms(torch, lambda: model(x, rc.KERNELS), 5)
                res["ms_per_tile_plain_composite"] = time_ms(torch, lambda: model(x, rc.PLAIN), 3)
                res["ms_per_tile_eager_cudnn"] = time_ms(torch, lambda: model.forward_eager(x), 5)
            del model, got, ref
            torch.cuda.empty_cache()
    emit({"phase": "forward", **res})
    if res["head_bias"]["argmax_agree"] <= 0.99:
        raise AssertionError(f"forward argmax agreement {res['head_bias']}")
    return res


def phase_fused(torch, rc, pc, profile_run: bool = False) -> tuple[list[dict], dict]:
    """K5 against its plain version at the 17 convs of the fused forward,
    then the full-width fused forward (with `profile_run`, one more under
    torch.profiler)."""
    import torch.nn.functional as F

    from boa_tpu_torch.models.unet import cast_model
    from boa_tpu_torch.models.unet_fused import pack_unet_params, unet_forward_fused

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    cases = []
    for s, cin, cout, pending in FUSED_CONVS:
        x = torch.tensor(rng.normal(size=(s, s, s, cin)), dtype=torch.bfloat16, device=dev)
        w = torch.tensor(rng.normal(size=(3, 3, 3, cin, cout)) * (1.0 / (27 * cin) ** 0.5),
                         dtype=torch.bfloat16, device=dev)
        b = torch.tensor(rng.normal(size=cout) * 0.1, dtype=torch.bfloat16, device=dev)
        if pending:
            norm = _norm(torch, pc, rng, 1, cin, dev)
            norm, slope = norm._replace(mean=norm.mean[0], inv_std=norm.inv_std[0]), 0.01
        else:
            norm, slope = pc.identity_normact(cin, dev), 1.0
        wp = pc.pack_in_act_weights(w)
        kern = lambda: pc.conv3d_in_act(x, norm, None, b, slope=slope,  # noqa: E731
                                        w_packed=wp, cin=cin, cout=cout)
        wrapper = lambda: pc.conv3d_in_act(x, norm, w, b, slope=slope)  # noqa: E731
        plain = lambda: pc.conv3d_in_act_plain(x, norm, w, b, slope=slope)  # noqa: E731
        wt = w.permute(4, 3, 0, 1, 2).contiguous()
        lib = lambda: F.conv3d(x[None].permute(0, 4, 1, 2, 3), wt, b, padding=1)  # noqa: E731
        y, sums = kern()
        torch.cuda.synchronize()
        yr, sr = plain()
        err = float((y.float() - yr.float()).abs().max())
        rel_sums = float((sums - sr).abs().max() / sr[1].abs().max())
        ok = bool(torch.allclose(y.float(), yr.float(), rtol=2e-2, atol=2e-2)) \
            and rel_sums <= 1e-2 and y.shape == (s, s, s, cout)
        nbytes = (x.numel() * 2 + w.numel() * 2 + cout * 2 + 4 * cin * 4
                  + s ** 3 * cout * 2 + 2 * cout * 4)
        bytes_ms, ops_ms = bound(nbytes, 2.0 * s ** 3 * 27 * cin * cout)
        cases.append({"name": "conv3d_in_act", "spatial": s, "cin": cin, "cout": cout,
                      "pending_norm": pending, "max_abs_err": err,
                      "rel_err_sums": rel_sums,
                      "kernel_ms": time_ms(torch, kern, 10),
                      "wrapper_ms": time_ms(torch, wrapper, 10),
                      "plain_ms": time_ms(torch, plain, 3),
                      "library_ms": time_ms(torch, lib, 10),
                      "bytes_ms": bytes_ms, "ops_ms": ops_ms, "ok": ok})
        del x, w, y, yr
        torch.cuda.empty_cache()
    bad = [c for c in cases if not c["ok"]]
    if bad:
        emit({"phase": "fused", "cases": cases})
        raise AssertionError(f"K5 disagrees with its plain version: {bad}")

    res = {}
    xb = torch.tensor(np.random.default_rng(3).normal(size=(1, 128, 128, 128, 1)),
                      dtype=torch.bfloat16, device=dev)
    x = xb[0]
    with torch.no_grad():
        model = cast_model(_total_fast_model(torch, 297, True), torch.bfloat16)
        packed = pack_unet_params(model)
        pc.reset_launches()
        rc.reset_launches()
        got = unet_forward_fused(model, packed, x).float()
        torch.cuda.synchronize()
        res["launches"] = pc.LAUNCHES["conv3d_in_act"]
        res["rowconv_launches"] = dict(rc.LAUNCHES)
        plain = unet_forward_fused(model, packed, x, conv=pc.conv3d_in_act_plain).float()
        eager = model.forward_eager(xb)[0].float()
        assert got.shape == (128, 128, 128, 118) and bool(torch.isfinite(got).all())
        res.update(
            argmax_agree_plain=float((got.argmax(-1) == plain.argmax(-1)).float().mean()),
            argmax_agree_eager=float((got.argmax(-1) == eager.argmax(-1)).float().mean()),
            max_abs_err_plain=float((got - plain).abs().max()),
            logit_absmax=float(plain.abs().max()))
        del got, plain, eager
        res["ms_per_tile_fused"] = time_ms(torch, lambda: unet_forward_fused(model, packed, x), 5)
        res["ms_per_tile_fused_plain"] = time_ms(
            torch, lambda: unet_forward_fused(model, packed, x, conv=pc.conv3d_in_act_plain), 2)
        res["ms_per_tile_composite"] = time_ms(torch, lambda: model(xb, rc.KERNELS), 5)
        res["ms_per_tile_eager_cudnn"] = time_ms(torch, lambda: model.forward_eager(xb), 5)
        if profile_run:
            res["profile"] = _profile(torch, lambda: unet_forward_fused(model, packed, x))
        del model, packed
        torch.cuda.empty_cache()
    emit({"phase": "fused", "cases": cases, **res})
    if res["launches"] != len(FUSED_CONVS) or any(res["rowconv_launches"].values()):
        raise AssertionError(f"fused forward launches {res}")
    if res["argmax_agree_plain"] <= 0.99 or res["argmax_agree_eager"] <= 0.98:
        raise AssertionError(f"fused forward argmax agreement {res}")
    return cases, res


def _bench_ct(shape, spacing):
    """The bench's synthetic anatomy: air, a soft-tissue ellipse, a dense
    core and mild noise."""
    from boa_tpu_torch.io.nifti import NiftiImage

    rng = np.random.default_rng(0)
    gx = np.linspace(-1, 1, shape[0], dtype=np.float32)[:, None]
    gy = np.linspace(-1, 1, shape[1], dtype=np.float32)[None, :]
    body = (gx ** 2 / 0.49 + gy ** 2 / 0.36) < 1.0
    core = (gx ** 2 / 0.04 + gy ** 2 / 0.04) < 1.0
    base = np.where(body, 40.0, -1000.0).astype(np.float32)
    base += np.where(core, 660.0, 0.0).astype(np.float32)
    vol = base[:, :, None] + 12.0 * rng.standard_normal(shape, dtype=np.float32)
    affine = np.diag([-spacing[0], -spacing[1], spacing[2], 1.0])
    affine[:3, 3] = (200.0, 180.0, -400.0)
    return NiftiImage(data=vol.astype(np.int16), affine=affine)


def _store(tmp, features, patch, label_names, head_bias: bool):
    from boa_tpu_torch.weights import convert as cv
    from boa_tpu_torch.weights.store import ModelStore, create_synthetic_model

    mdir = create_synthetic_model(
        tmp, 297, "TotalSegmentator_total_3mm_1559subj",
        num_classes=len(label_names),
        trainer="nnUNetTrainer_4000epochs_NoMirroring", patch_size=patch,
        spacing=(3.0, 3.0, 3.0), features=features, label_names=label_names)
    if head_bias:  # the bench's trick: coherent regions from random weights
        path = mdir / "fold_0" / "checkpoint_final.npz"
        p0 = cv.load_params_npz(path)
        head = p0["seg_heads"][-1]
        head["b"] = head["b"] + np.asarray(np.random.default_rng(7).normal(
            0, 3.0, head["b"].shape), head["b"].dtype)
        cv.save_params_npz(p0, path)
    return ModelStore(tmp)


def _profile(torch, run) -> dict:
    """One run under torch.profiler: device busy share and the kernels that
    take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():   # kernels only: op rows repeat their time
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us / 1e3, ev.count, ev.key[:90]))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / (wall * 1e3)),
            "top": [{"ms": r[0], "calls": r[1], "name": r[2]} for r in rows[:15]]}


def phase_study(torch, rc, pc, profile_run: bool = False) -> dict:
    from boa_tpu_torch.inference.pipeline import predict_image
    from boa_tpu_torch.tasks.class_maps import get_class_map

    label_names = ["background"] + list(get_class_map("total").values())
    res = {}

    # --- small study: card (kernels) against the CPU (plain versions)
    with tempfile.TemporaryDirectory() as tmp:
        store = _store(tmp, (32, 64, 128), (32, 32, 32), label_names, True)
        img = _bench_ct((96, 96, 64), (1.5, 1.5, 3.0))
        rc.reset_launches()
        pc.reset_launches()
        gpu = predict_image(img, "total", store, fast=True, device="cuda").seg.data
        launches_small = dict(rc.LAUNCHES, **pc.LAUNCHES)
        cpu = predict_image(img, "total", store, fast=True, device="cpu").seg.data
        res["small_agree"] = float((gpu == cpu).mean())
        res["small_launches"] = launches_small
        assert gpu.shape == img.shape and min(launches_small[k] for k in rc.LAUNCHES) > 0
        assert launches_small["conv3d_in_act"] == 0, launches_small
        assert res["small_agree"] > 0.99, res

    # --- the 512x512x300 fast-total study
    shape, spacing = (512, 512, 300), (1.5, 1.5, 3.0)
    with tempfile.TemporaryDirectory() as tmp:
        store = _store(tmp, TOTAL_FAST_FEATURES, (128, 128, 128), label_names, True)
        img = _bench_ct(shape, spacing)
        times, runs = [], []
        torch.cuda.reset_peak_memory_stats()
        for i in range(4):
            spans: dict = {}
            rc.reset_launches()
            pc.reset_launches()
            t0 = time.perf_counter()
            r = predict_image(img, "total", store, fast=True, spans=spans)
            dt = time.perf_counter() - t0
            launches = dict(rc.LAUNCHES, **pc.LAUNCHES)
            tiles = spans["tiles"]
            want = {"conv3d_rows": 4 * tiles, "conv3d_rows_stride2": tiles,
                    "transpconv2_rows": tiles, "conv3d_in_act": 0}
            assert tiles > 0 and launches == want, (launches, want)
            seg = r.seg.data
            assert seg.shape == shape and seg.dtype == np.uint8
            assert int(seg.max()) <= 117 and len(np.unique(seg)) > 1
            runs.append({"s": dt, "spans": spans, "launches": launches})
            if i > 0:
                times.append(dt)
        res.update(
            sec_min=min(times), sec_median=statistics.median(times),
            warmup_s=runs[0]["s"], tiles=tiles,
            model_grid=list(r.seg_model_grid.shape),
            labels_present=int(len(np.unique(seg))),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            spans=runs[-1]["spans"], launches=runs[-1]["launches"])
        if profile_run:
            res["profile"] = _profile(torch, lambda: predict_image(
                img, "total", store, fast=True))
    emit({"phase": "study", **res})
    return res


def _row(name: str, mine: list[dict], checked: list[dict], launches: int) -> dict:
    """The kernel summary row: times and bounds summed over `mine`, the calls
    of one tile's forward; the largest error over every `checked` call."""
    per = [(max(c["bytes_ms"], c["ops_ms"]), c["ops_ms"] >= c["bytes_ms"]) for c in mine]
    bound_ms = sum(b for b, _ in per)
    ops_part = sum(b for b, by_ops in per if by_ops)
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in checked),
            "ms": sum(c["kernel_ms"] for c in mine),
            "wrapper_ms": sum(c["wrapper_ms"] for c in mine),
            "plain_ms": sum(c["plain_ms"] for c in mine),
            "bound_ms": bound_ms,
            "bound_by": "operations" if 2 * ops_part >= bound_ms else "bytes",
            "library_ms": sum(c["library_ms"] for c in mine)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from boa_tpu_torch import _build
    from boa_tpu_torch.device import resolve_device
    from boa_tpu_torch.ops import pallas_conv as pc
    from boa_tpu_torch.ops import rowconv as rc

    resolve_device("cuda")  # pins the float32 precision flags
    profile_run = "--profile" in sys.argv[1:]
    phase_device(torch, _build)
    cases = phase_kernels(torch, rc)
    phase_forward(torch, rc)
    fused_cases, fused = phase_fused(torch, rc, pc, profile_run)
    study = phase_study(torch, rc, pc, profile_run)

    summary = []
    for name in REPLACES:
        if name == "conv3d_in_act":  # per fused forward: its 17 calls
            summary.append(_row(name, fused_cases, fused_cases, fused["launches"]))
            continue
        # per tile: the four conv3d_rows calls are 1->32, 32->32, 64->32,
        # 32->32; K2 and K3 on the concat slice, as the main path runs them
        mine = [c for c in cases if c["name"] == name and c["n"] == 1]
        if name == "conv3d_rows":
            mine = mine + [c for c in mine if c["cin"] == 32]
        else:
            mine = [c for c in mine if c["layout"] == "concat"]
        summary.append(_row(name, mine, [c for c in cases if c["name"] == name],
                            study["launches"][name]))
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
