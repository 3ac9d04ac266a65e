"""The port's training side against the reference on the CPU: losses (1e-6),
schedules, the clip and the three optimizers (rtol 1e-5, atol 1e-6), a full
float32 train step with deep supervision from the same parameters and batch
(loss 1e-5 relative, grad norm 1e-4, parameters rtol 1e-4 / atol 1e-6),
checkpoints resumed across the packages, the case store, the loader's
batches and the splits bit for bit, the trainer variants, the row-conv pack
cache after an optimizer step, `run_training` with its folds, validation,
pretrained weights and device rule, and the cascade bridge."""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boa_tpu.models.unet import ArchConfig as RefArch
from boa_tpu.train import losses as rl
from boa_tpu.train import optim as ro
from boa_tpu_torch.models.unet import ArchConfig
from boa_tpu_torch.train import losses as pl
from boa_tpu_torch.train import optim as po
from boa_tpu_torch.weights.convert import _flatten, params_from_numpy, params_to_numpy
from boa_tpu_torch.weights.store import init_params_numpy

LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
OPT_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


def _logits(seed, shape=(2, 8, 6, 5, 4)):
    r = np.random.default_rng(seed)
    lg = (r.normal(size=shape) * 2).astype(np.float32)
    y = r.integers(0, shape[-1], size=shape[:-1]).astype(np.int32)
    return lg, y


# ---------------------------------------------------------------- losses
@pytest.mark.parametrize("name", ["dice_ce", "dice_ce_nosmooth", "ce", "dice", "topk10",
                                  "topk10_ls01", "dice_topk10"])
@pytest.mark.parametrize("batch_dice", [True, False])
def test_make_loss_matches_reference(name, batch_dice):
    lg, y = _logits(1)
    want = float(rl.make_loss(name, batch_dice=batch_dice)(jnp.asarray(lg), jnp.asarray(y)))
    got = float(pl.make_loss(name, batch_dice=batch_dice)(_t(lg), _t(y)))
    np.testing.assert_allclose(got, want, **LOSS_TOL)


def test_losses_with_mask_and_gradients_match_reference():
    lg, y = _logits(2)
    mask = np.random.default_rng(3).random(lg.shape[:-1]) > 0.3
    for rf, pf in ((rl.soft_dice_loss, pl.soft_dice_loss), (rl.dice_ce_loss, pl.dice_ce_loss)):
        want = rf(jnp.asarray(lg), jnp.asarray(y), loss_mask=jnp.asarray(mask))
        got = pf(_t(lg), _t(y), loss_mask=_t(mask))
        np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    want = rl.softmax_ce_loss(jnp.asarray(lg), jnp.asarray(y), jnp.asarray(mask))
    np.testing.assert_allclose(float(pl.softmax_ce_loss(_t(lg), _t(y), _t(mask))),
                               float(want), **LOSS_TOL)
    # d loss / d logits
    g_ref = jax.grad(lambda z: rl.dice_ce_loss(z, jnp.asarray(y)))(jnp.asarray(lg))
    z = _t(lg).requires_grad_(True)
    pl.dice_ce_loss(z, _t(y)).backward()
    np.testing.assert_allclose(_np(z.grad), np.asarray(g_ref), rtol=1e-5, atol=1e-7)


def test_deep_supervision_and_downsample_match_reference():
    r = np.random.default_rng(4)
    y = r.integers(0, 3, size=(2, 16, 12, 8)).astype(np.int32)
    outs = [(r.normal(size=(2, 16 // 2 ** i, 12 // 2 ** i, 8 // 2 ** i, 3)) * 2
             ).astype(np.float32) for i in range(3)]
    for o in outs:
        np.testing.assert_array_equal(
            _np(pl.downsample_target(_t(y), o.shape[1:-1])),
            np.asarray(rl.downsample_target(jnp.asarray(y), o.shape[1:-1])))
    # an odd shrink
    np.testing.assert_array_equal(_np(pl.downsample_target(_t(y), (5, 7, 3))),
                                  np.asarray(rl.downsample_target(jnp.asarray(y), (5, 7, 3))))
    for n in (1, 2, 3, 5):
        np.testing.assert_array_equal(pl.ds_weights(n), rl.ds_weights(n))
    want = rl.deep_supervision_loss([jnp.asarray(o) for o in outs], jnp.asarray(y))
    got = pl.deep_supervision_loss([_t(o) for o in outs], _t(y))
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def test_pseudo_dice_and_regions_match_reference():
    lg, y = _logits(5, (2, 6, 6, 6, 5))
    y[y == 3] = 0   # an absent class: NaN unless predicted
    want = np.asarray(rl.pseudo_dice(jnp.asarray(lg), jnp.asarray(y)))
    got = _np(pl.pseudo_dice(_t(lg), _t(y)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)], **LOSS_TOL)
    regions = ((1, 2, 3, 4), (2, 3), 4)
    mh = np.asarray(rl.regions_to_multihot(jnp.asarray(y), regions))
    np.testing.assert_array_equal(_np(pl.regions_to_multihot(_t(y), regions)), mh)
    lr = lg[..., :3]
    np.testing.assert_allclose(float(pl.dice_bce_loss(_t(lr), _t(mh))),
                               float(rl.dice_bce_loss(jnp.asarray(lr), jnp.asarray(mh))),
                               **LOSS_TOL)
    np.testing.assert_allclose(_np(pl.pseudo_dice_regions(_t(lr), _t(y), regions)),
                               np.asarray(rl.pseudo_dice_regions(jnp.asarray(lr),
                                                                 jnp.asarray(y), regions)),
                               **LOSS_TOL)
    outs = [lr, lr[:, ::2, ::2, ::2]]
    np.testing.assert_allclose(
        float(pl.deep_supervision_loss_regions([_t(o) for o in outs], _t(y), regions)),
        float(rl.deep_supervision_loss_regions([jnp.asarray(o) for o in outs],
                                               jnp.asarray(y), regions)), **LOSS_TOL)


# ---------------------------------------------------------------- optimizer
def test_schedules_match_reference():
    for step in (0, 1, 49, 50, 51, 500, 999):
        assert po.poly_lr(1e-2, step, 1000) == pytest.approx(float(ro.poly_lr(1e-2, step, 1000)),
                                                             rel=1e-12)
        assert po.cosine_anneal_lr(1e-2, step, 1000) == ro.cosine_anneal_lr(1e-2, step, 1000)
        assert po.lin_incr_lr(3e-4, step, 50) == ro.lin_incr_lr(3e-4, step, 50)
        assert po.poly_lr_offset(3e-4, step, 1000, 50) == ro.poly_lr_offset(3e-4, step, 1000, 50)


@pytest.mark.parametrize("max_norm", [12.0, 1.0, 1e3])
def test_clip_matches_reference(max_norm):
    r = np.random.default_rng(6)
    grads = [(r.normal(size=s) * 3).astype(np.float32) for s in ((5, 7), (11,), (2, 3, 4))]
    ref, ref_norm = ro.clip_by_global_norm([jnp.asarray(g) for g in grads], max_norm)
    mine = [_t(g.copy()) for g in grads]
    norm = po.clip_by_global_norm(mine, max_norm)
    np.testing.assert_allclose(float(norm), float(ref_norm), **OPT_TOL)
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), **OPT_TOL)


@pytest.mark.parametrize("name", ["sgd", "adamw_amsgrad", "adamw", "adam"])
def test_optimizers_and_state_carry_match_reference(name):
    """Four steps of torch's optimizer against the reference's update, with
    the state written in the reference's layout after every step and read
    back into a fresh optimizer halfway."""
    cfg = ArchConfig(n_stages=2, features_per_stage=(4, 8), kernel_sizes=((3, 3, 3),) * 2,
                     strides=((1, 1, 1), (2, 2, 2)), n_conv_per_stage=(2, 2),
                     n_conv_per_stage_decoder=(2,), num_classes=3)
    params = init_params_numpy(cfg, 1)
    model = params_from_numpy(params, cfg, device="cpu")
    wd = 5e-2 if name.startswith("adamw") else 3e-5
    betas = (0.9, 0.98)
    opt = po.make_optimizer(name, model.parameters(), 1e-2, weight_decay=wd, betas=betas)
    ref_p = jax.tree.map(jnp.asarray, params)
    if name == "sgd":
        ref_s = ro.init_sgd_state(ref_p)
        upd = lambda p, g, s, lr: ro.sgd_nesterov_update(p, g, s, lr)  # noqa: E731
    else:
        ref_s = ro.init_adam_state(ref_p, amsgrad=name == "adamw_amsgrad")
        fn = ro.adam_update if name == "adam" else ro.adamw_update
        upd = lambda p, g, s, lr: fn(p, g, s, lr, betas=betas, weight_decay=wd,  # noqa: E731
                                     amsgrad=name == "adamw_amsgrad")
    r = np.random.default_rng(7)
    for it in range(4):
        gtree = jax.tree.map(lambda a: r.normal(size=a.shape).astype(np.float32), params)
        ref_p, ref_s = upd(ref_p, jax.tree.map(jnp.asarray, gtree), ref_s, 1e-2)
        from boa_tpu_torch.weights.convert import kernel_from_numpy, param_leaves, tree_get

        for path, p in param_leaves(model):
            p.grad = kernel_from_numpy(tree_get(gtree, path), p)
        opt.step()
        if it == 1:   # the carry: through the reference's tree into a fresh optimizer
            tree = po.opt_state_to_numpy(model, opt)
            opt = po.make_optimizer(name, model.parameters(), 1e-2, weight_decay=wd,
                                    betas=betas)
            po.opt_state_from_numpy(model, opt, tree)
        a, b = {}, {}
        _flatten(params_to_numpy(model), "", a)
        _flatten(jax.tree.map(np.asarray, ref_p), "", b)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **OPT_TOL)
        a, b = {}, {}
        _flatten(po.opt_state_to_numpy(model, opt), "", a)
        _flatten(jax.tree.map(np.asarray, ref_s), "", b)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], err_msg=k, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------- train step
def _arch(feats=(8, 16, 32), n_cls=3, ds=True, **kw) -> ArchConfig:
    n = len(feats)
    return ArchConfig(n_stages=n, features_per_stage=feats, kernel_sizes=((3, 3, 3),) * n,
                      strides=((1, 1, 1),) + ((2, 2, 2),) * (n - 1),
                      n_conv_per_stage=(2,) * n, n_conv_per_stage_decoder=(2,) * (n - 1),
                      num_classes=n_cls, deep_supervision=ds, **kw)


def _ref_cfg(cfg):
    from boa_tpu.train.trainer import TrainConfig as RefCfg

    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["arch"] = RefArch(**dataclasses.asdict(cfg.arch))
    return RefCfg(**d)


def _batch(seed, size=16, batch=2, n_cls=3):
    r = np.random.default_rng(seed)
    x = np.zeros((batch, size, size, size, 1), np.float32)
    y = np.zeros((batch, size, size, size), np.int32)
    coords = np.stack(np.meshgrid(*[np.arange(size)] * 3, indexing="ij"), -1)
    for b in range(batch):
        c = r.uniform(4, size - 4, 3)
        rad = r.uniform(3, 6)
        d = np.linalg.norm(coords - c, axis=-1)
        y[b] = np.where(d < rad / 2, n_cls - 1, np.where(d < rad, 1, 0))
        x[b, ..., 0] = y[b] * 2.0 - 1.0 + r.normal(size=(size,) * 3) * 0.3
    return x, y


def _trees_close(a_tree, b_tree, **tol):
    a, b = {}, {}
    _flatten(a_tree, "", a)
    _flatten(jax.tree.map(np.asarray, b_tree), "", b)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)


# Adam's normalization turns a gradient near its eps (1e-8) into a step
# whose size follows the gradient's last digits, and a conv bias before an
# instance norm has only rounding noise for a gradient: so the Adam cases
# train without conv biases and are held through their moments (m, v, vmax,
# step), which with the update `test_optimizers_and_state_carry_match_reference`
# holds on equal gradients fix the parameters; the SGD cases through the
# parameters too.
@pytest.mark.parametrize("variant", [
    dict(),                                                  # SGD, Dice+CE, deep supervision
    dict(optimizer="adamw_amsgrad", loss="dice_topk10", initial_lr=3e-4,
         arch_kw=dict(conv_bias=False)),
    dict(optimizer="adam", loss="ce", initial_lr=3e-4,
         arch_kw=dict(ds=False, conv_bias=False)),
    dict(regions=((1, 2), 2)),
], ids=["sgd_ds", "adamw_topk", "adam_ce_nods", "regions"])
def test_fp32_train_step_matches_reference(variant):
    """One float32 step from the same parameters and batch: loss 1e-5
    relative, grad norm 1e-4, parameters and optimizer state rtol 1e-4 /
    atol 1e-6, through the port's step (functional_call on the masters);
    then the second step's loss. (After a step, a pre-activation near zero
    may fall on either side of the LeakyReLU's kink in either package, so
    the second step's gradients are held through the loss only.)"""
    from boa_tpu.train.trainer import init_opt_state as ref_init, make_train_step as ref_step
    from boa_tpu_torch.train.trainer import (TrainConfig, init_opt_state,
                                             make_train_step)

    variant = dict(variant)
    arch_kw = variant.pop("arch_kw", {})
    regions = variant.get("regions")
    cfg = TrainConfig(arch=_arch(n_cls=len(regions) if regions else 3, **arch_kw),
                      compute_dtype="float32", **variant)
    params = init_params_numpy(cfg.arch, 3)
    x, y = _batch(11)
    rcfg = _ref_cfg(cfg)
    rp = jax.tree.map(jnp.asarray, params)
    rs = ref_init(rcfg, rp)
    step = ref_step(rcfg, donate=False)
    model = params_from_numpy(params, cfg.arch, device="cpu")
    opt = init_opt_state(cfg, model)
    mine = make_train_step(cfg)
    lr = cfg.initial_lr
    rp, rs, m = step(rp, rs, jnp.asarray(x), jnp.asarray(y), jnp.float32(lr))
    got = mine(model, opt, _t(x), _t(y), lr)
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(m["grad_norm"]), rtol=1e-4)
    _trees_close(po.opt_state_to_numpy(model, opt), rs, rtol=1e-4, atol=1e-6)
    if cfg.optimizer == "sgd":
        _trees_close(params_to_numpy(model), rp, rtol=1e-4, atol=1e-6)
    # the next step's loss, from the updated state (the momentum carried)
    _, _, m = step(rp, rs, jnp.asarray(x), jnp.asarray(y), jnp.float32(lr / 2))
    got = mine(model, opt, _t(x), _t(y), lr / 2)
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]), rtol=1e-5)


def _gen(seed, size=16, batch=2):
    i = 0
    while True:
        yield _batch(seed + i, size, batch)
        i += 1


def test_checkpoints_resume_across_packages(tmp_path):
    """The reference's checkpoint resumes in the port and the port's in the
    reference; both then take the same step."""
    from boa_tpu.train.trainer import Trainer as RefTrainer
    from boa_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(arch=_arch(), compute_dtype="float32", num_epochs=5,
                      iters_per_epoch=1)
    ref = RefTrainer(_ref_cfg(cfg), tmp_path / "ref")
    ref.train_epoch(_gen(20), n_iters=2)
    ref.save_checkpoint(tmp_path / "ref.pkl")
    mine = Trainer(cfg, tmp_path / "mine", device="cpu")
    mine.load_checkpoint(tmp_path / "ref.pkl")
    assert mine.state.epoch == 1 and mine.state.logs == ref.state.logs
    assert float(np.asarray(jax.tree.leaves(ref.state.momentum_buf)[0]).std()) > 0
    _trees_close(params_to_numpy(mine.state.model), ref.state.params, rtol=0, atol=0)
    _trees_close(po.opt_state_to_numpy(mine.state.model, mine.state.optimizer),
                 ref.state.momentum_buf, rtol=0, atol=0)
    a = mine.train_epoch(_gen(40))
    b = ref.train_epoch(_gen(40))
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    _trees_close(params_to_numpy(mine.state.model), ref.state.params, rtol=1e-4, atol=1e-6)
    # the port's checkpoint in the reference
    mine.save_checkpoint(tmp_path / "mine.pkl")
    back = RefTrainer(_ref_cfg(cfg), tmp_path / "back")
    back.load_checkpoint(tmp_path / "mine.pkl")
    assert back.state.epoch == 2
    _trees_close(params_to_numpy(mine.state.model), back.state.params, rtol=0, atol=0)
    _trees_close(po.opt_state_to_numpy(mine.state.model, mine.state.optimizer),
                 back.state.momentum_buf, rtol=0, atol=0)
    b2 = back.train_epoch(_gen(60))
    a2 = mine.train_epoch(_gen(60))
    np.testing.assert_allclose(a2["loss"], b2["loss"], rtol=1e-5)
    with open(tmp_path / "mine.pkl", "rb") as f:
        blob = pickle.load(f)
    assert set(blob) == {"params", "momentum_buf", "epoch", "best_ema", "ema_dice", "logs"}


def test_adam_checkpoint_carries_step_and_moments(tmp_path):
    from boa_tpu.train.trainer import Trainer as RefTrainer
    from boa_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(arch=_arch(feats=(4, 8), conv_bias=False), compute_dtype="float32",
                      optimizer="adamw_amsgrad", initial_lr=3e-4, num_epochs=5,
                      iters_per_epoch=1)
    mine = Trainer(cfg, tmp_path / "mine", device="cpu")
    mine.train_epoch(_gen(70), n_iters=2)
    mine.save_checkpoint(tmp_path / "a.pkl")
    ref = RefTrainer(_ref_cfg(cfg), tmp_path / "ref")
    ref.load_checkpoint(tmp_path / "a.pkl")
    assert int(ref.state.momentum_buf["step"]) == 2
    b = ref.train_epoch(_gen(80))
    a = mine.train_epoch(_gen(80))
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    _trees_close(params_to_numpy(mine.state.model), ref.state.params, rtol=1e-4, atol=1e-6)


def test_trainer_logs_and_checkpoints(tmp_path):
    from boa_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(arch=_arch(feats=(4, 8)), compute_dtype="float32", num_epochs=2,
                      iters_per_epoch=2)
    tr = Trainer(cfg, tmp_path, device="cpu")
    for _ in range(2):
        logs = tr.train_epoch(_gen(90))
    tr.final_checkpoint()
    assert {"checkpoint_best.pkl", "checkpoint_latest.pkl", "checkpoint_final.pkl",
            "training_log.json"} <= {p.name for p in tmp_path.iterdir()}
    saved = json.loads((tmp_path / "training_log.json").read_text())
    assert [e["epoch"] for e in saved] == [0, 1]
    assert len(logs["iter_s"]) == 2 and logs["loader_wait_s"] >= 0
    assert 0 <= logs["device_wait_s"] <= sum(logs["iter_s"]) <= logs["epoch_time"]
    assert np.isfinite(logs["loss"]) and 0 <= logs["dice"] <= 1


def test_pack_cache_follows_the_optimizer_step(tmp_path):
    """The eval copy takes the K1-K3 composite in bf16; after an optimizer
    step refreshes it in place, the composite equals a fresh network's and
    the eager forward's, and differs from the stale weights' output."""
    from boa_tpu_torch.models.unet import _row_packs
    from boa_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(arch=_arch(feats=(8, 16)), num_epochs=2, iters_per_epoch=1,
                      initial_lr=0.5)
    tr = Trainer(cfg, tmp_path / "trainer", device="cpu")
    x, y = _batch(100, size=16)
    xb = _t(x).to(torch.bfloat16)
    with torch.no_grad():
        ev = tr.eval_model()
        before = ev(xb).float()
        packs = _row_packs(ev)
    tr._step(tr.state.model, tr.state.optimizer, _t(x), _t(y), 0.5)
    with torch.no_grad():
        ev = tr.eval_model()
        after = ev(xb).float()
        assert _row_packs(ev) is not packs
        fresh = params_from_numpy(params_to_numpy(tr.state.model), cfg.arch, device="cpu")
        fresh = fresh.to(torch.bfloat16)
        np.testing.assert_array_equal(_np(after), _np(fresh(xb).float()))
        eager = ev.forward_eager(xb).float()
    assert not torch.equal(before, after)
    scale = float(eager.abs().max())
    assert float((after - eager).abs().max()) <= 2e-2 * scale + 2e-2
    assert float((after.argmax(-1) == eager.argmax(-1)).float().mean()) > 0.99


# ---------------------------------------------------------------- data
@pytest.fixture()
def stores(tmp_path):
    from boa_tpu.train.dataset import CaseStore as RefStore
    from boa_tpu_torch.train.dataset import CaseStore

    r = np.random.default_rng(12)
    mine, ref = CaseStore(tmp_path / "mine"), RefStore(tmp_path / "ref")
    for i in range(4):
        shape = (20 + i, 18, 14)
        data = r.normal(size=shape).astype(np.float32)
        seg = np.zeros(shape, np.int8)
        seg[3:9, 4:9, 2:8] = 1
        seg[12:16, 10:14, 6:12] = 2
        for st in (mine, ref):
            st.save_case(f"case_{i}", data, seg, properties={"spacing": [1.0, 1.0, 2.0]})
            st.save_prev_seg(f"case_{i}", np.roll(seg, 2, axis=0))
    return mine, ref


def test_case_store_files_equal_reference(stores):
    mine, ref = stores
    assert mine.case_ids() == ref.case_ids()
    for p in sorted(mine.root.iterdir()):
        q = ref.root / p.name
        if p.suffix == ".npz":
            a, b = np.load(p), np.load(q)
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            assert p.read_bytes() == q.read_bytes(), p.name


def test_splits_equal_reference():
    from boa_tpu.train.dataset import generate_splits as ref_splits
    from boa_tpu_torch.train.dataset import generate_splits

    for n in (3, 5, 7, 12, 31):
        ids = [f"c{i:03d}" for i in range(n)]
        assert generate_splits(ids) == ref_splits(ids)


@pytest.mark.parametrize("kw", [dict(), dict(probabilistic_oversampling=True),
                                dict(cascade=True), dict(cascade=True, cascade_cc_dropout_p=1.0)],
                         ids=["round_rule", "probabilistic", "cascade", "cascade_dropout"])
def test_loader_batches_bit_equal_reference(stores, kw):
    from boa_tpu.train.dataloader import DataLoader as RefLoader
    from boa_tpu_torch.train.dataloader import DataLoader

    mine, ref = stores
    a = DataLoader(mine, (16, 16, 16), 3, seed=5, **kw)
    b = RefLoader(ref, (16, 16, 16), 3, seed=5, **kw)
    for _ in range(4):
        for u, v in zip(a.next_batch(), b.next_batch()):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


def test_prefetch_pins_and_sends(stores):
    from boa_tpu.train.dataloader import DataLoader as RefLoader
    from boa_tpu_torch.train.dataloader import DataLoader, to_device

    mine, ref = stores
    it = DataLoader(mine, (24, 20, 16), 2, seed=9).prefetched(pin=False)
    want = RefLoader(ref, (24, 20, 16), 2, seed=9)
    for _ in range(3):
        x, y = to_device(next(it), torch.device("cpu"))
        wx, wy = want.next_batch()
        np.testing.assert_array_equal(_np(x), wx)
        np.testing.assert_array_equal(_np(y), wy)
    it.close()


# ---------------------------------------------------------------- variants
def test_apply_variant_matches_reference():
    from boa_tpu.train.variants import VARIANTS, apply_variant as ref_apply
    from boa_tpu_torch.train.trainer import TrainConfig
    from boa_tpu_torch.train.variants import apply_variant

    cfg = TrainConfig(arch=_arch())
    for name in list(VARIANTS) + ["nnUNetTrainer_250epochs", "nnUNetTrainer_8000epochs_NoMirroring"]:
        if name == "nnUNetTrainerBN":
            with pytest.raises(ValueError):
                apply_variant(cfg, name)
            continue
        for bs in (2, 3):
            got, spec = apply_variant(cfg, name, batch_size=bs)
            want, rspec = ref_apply(_ref_cfg(cfg), name, batch_size=bs)
            gd = dataclasses.asdict(got)
            wd = dataclasses.asdict(want)
            assert gd == wd, name
            assert dataclasses.asdict(spec) == dataclasses.asdict(rspec)


def test_build_trainer_arch_matches_reference(tmp_path):
    from boa_tpu.train.run_training import build_trainer as ref_build
    from boa_tpu_torch.train.run_training import build_trainer

    for patch in ((32, 32, 32), (64, 32, 16), (32, 32, 1)):
        mine, _, _ = build_trainer(tmp_path, patch, 4, features=(4, 8, 16, 32), epochs=3,
                                   iters=2, device="cpu")
        ref, _, _ = ref_build(tmp_path, patch, 4, features=(4, 8, 16, 32), epochs=3, iters=2)
        assert dataclasses.asdict(mine.cfg.arch) == dataclasses.asdict(ref.cfg.arch)
    # a mesh needs the process group of its ranks first
    with pytest.raises(ValueError, match="initialize_distributed"):
        build_trainer(tmp_path, (32, 32, 32), 3, mesh_shape=(2, 1, 1), device="cpu")


# ---------------------------------------------------------------- run_training
@pytest.fixture()
def case_dir(tmp_path):
    from boa_tpu_torch.train.dataset import CaseStore

    st = CaseStore(tmp_path / "cases")
    r = np.random.default_rng(13)
    for i in range(3):
        shape = (24, 20 + 2 * i, 18)
        seg = np.zeros(shape, np.int8)
        seg[4:12, 4:12, 4:12] = 1
        seg[14:20, 8:16, 6:14] = 2
        data = (seg * 1.5 + r.normal(size=shape) * 0.3).astype(np.float32)
        st.save_case(f"case_{i}", data, seg, properties={"spacing": [2.0, 2.0, 2.0]})
    return st.root


def test_run_training_fold_validation_and_resume(case_dir, tmp_path):
    from boa_tpu_torch.train.run_training import run_training

    out = tmp_path / "out"
    kw = dict(patch=(16, 16, 16), batch_size=2, epochs=1, iters=2, fold=0,
              features=(4, 8), device="cpu", compute_dtype="float32")
    last = run_training(case_dir, out, validate=True, **kw)
    assert np.isfinite(last["loss"])
    summary = json.loads((out / "validation" / "summary.json").read_text())
    assert "foreground_mean" in summary
    assert len(list((out / "validation").glob("*.nii.gz"))) == 1
    meta = json.loads((out / "export_meta.json").read_text())
    assert meta == {"patch_size": [16, 16, 16], "num_classes": 3,
                    "features_per_stage": [4, 8], "cases_dir": str(case_dir.resolve())}
    assert json.loads((case_dir / "splits_final.json").read_text())[0]["val"]
    # resume continues from the latest checkpoint's epoch
    import shutil

    shutil.copy(out / "checkpoint_final.pkl", out / "checkpoint_latest.pkl")
    kw["epochs"] = 2
    last = run_training(case_dir, out, resume=True, **kw)
    assert last["epoch"] == 1


def test_run_training_variants_and_pretrained(case_dir, tmp_path):
    """`-tr` DA5 and NoDA, a cascade stage, and encoder/decoder weights from
    a reference checkpoint with the heads kept fresh."""
    from boa_tpu.train.trainer import Trainer as RefTrainer
    from boa_tpu_torch.train.dataset import CaseStore
    from boa_tpu_torch.train.run_training import build_trainer, load_pretrained_weights, main

    kw = dict(features=(4, 8), device="cpu")
    main([str(case_dir), str(tmp_path / "da5"), "--patch", "16", "16", "16", "--epochs", "1",
          "--iters", "1", "-tr", "nnUNetTrainerDA5", "-d", "cpu"])
    assert (tmp_path / "da5" / "checkpoint_final.pkl").exists()
    st = CaseStore(case_dir)
    for cid in st.case_ids():
        st.save_prev_seg(cid, np.asarray(st.load_case(cid).seg))
    from boa_tpu_torch.train.run_training import run_training

    run_training(case_dir, tmp_path / "casc", patch=(16, 16, 16), epochs=1, iters=1,
                 cascade=True, num_classes=3, trainer_name="nnUNetTrainerNoDA", **kw)
    ref, _, _ = build_trainer(tmp_path / "t", (16, 16, 16), 3, **kw)
    from boa_tpu.train.run_training import build_trainer as ref_build

    rt, _, _ = ref_build(tmp_path / "r", (16, 16, 16), 5, features=(4, 8))
    rt.save_checkpoint(tmp_path / "pre.pkl")
    heads = [p.detach().clone() for p in ref.state.model.seg_heads.parameters()]
    load_pretrained_weights(ref.state.model, tmp_path / "pre.pkl")
    got = params_to_numpy(ref.state.model)
    want = jax.tree.map(np.asarray, rt.state.params)
    _trees_close({k: got[k] for k in ("encoder", "decoder")},
                 {k: want[k] for k in ("encoder", "decoder")}, rtol=0, atol=0)
    for a, b in zip(heads, ref.state.model.seg_heads.parameters()):
        assert torch.equal(a, b)
    small, _, _ = build_trainer(tmp_path / "s", (16, 16, 16), 3, features=(2, 4),
                                device="cpu")
    with pytest.raises(ValueError, match="not compatible"):
        load_pretrained_weights(small.state.model, tmp_path / "pre.pkl")
    assert isinstance(RefTrainer, type)


def test_entry_points_need_cuda_unless_cpu(case_dir, tmp_path, monkeypatch):
    from boa_tpu_torch.train.run_training import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main([str(case_dir), str(tmp_path / "o"), "--epochs", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        from boa_tpu_torch.train.trainer import TrainConfig, Trainer

        Trainer(TrainConfig(arch=_arch()), tmp_path / "t")


@pytest.mark.parametrize("name,err", [("gpu", RuntimeError), ("cuda:0", RuntimeError),
                                      ("tpu", ValueError)])
def test_build_trainer_takes_run_trainings_device_names(tmp_path, monkeypatch, name, err):
    """`build_trainer` resolves the user-facing names as `run_training` does:
    the card's names raise without CUDA, an unknown name raises ValueError."""
    from boa_tpu_torch.train.run_training import build_trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(err, match="CUDA" if err is RuntimeError else "unsupported"):
        build_trainer(tmp_path, (16, 16, 16), 3, features=(2, 4), device=name)
    tr, _, _ = build_trainer(tmp_path, (16, 16, 16), 3, features=(2, 4), device="cpu")
    assert tr.device == torch.device("cpu")


def test_predict_next_stage_matches_reference(case_dir, tmp_path):
    from boa_tpu.train.cascade import predict_next_stage as ref_next
    from boa_tpu.train.dataset import CaseStore as RefStore
    from boa_tpu_torch.train.cascade import predict_next_stage
    from boa_tpu_torch.train.dataset import CaseStore

    cfg = _arch(feats=(8, 16), ds=False)
    params = init_params_numpy(cfg, 4)
    # a strong head bias on class 1 where the intensity is high
    params["seg_heads"][-1]["b"] = np.array([0.5, 0.0, -0.5], np.float32)
    low = CaseStore(case_dir)
    import shutil

    for name in ("mine", "ref"):
        shutil.copytree(case_dir, tmp_path / name)
    predict_next_stage(params, cfg, low, CaseStore(tmp_path / "mine"), (16, 16, 16),
                       device="cpu")
    ref_next(jax.tree.map(jnp.asarray, params), RefArch(**dataclasses.asdict(cfg)),
             RefStore(case_dir), RefStore(tmp_path / "ref"), (16, 16, 16))
    for cid in low.case_ids():
        a = np.load(tmp_path / "mine" / f"{cid}_prevseg.npy")
        b = np.load(tmp_path / "ref" / f"{cid}_prevseg.npy")
        assert a.shape == b.shape
        assert (a == b).mean() > 0.99


@pytest.mark.parametrize("ignore_label", [None, 2])
def test_validation_evaluation_equal_reference(ignore_label):
    """The validation's evaluation (integer labels counted in one pass of
    bincounts; a region label by its mask) against the reference's per-label
    passes: the same summary."""
    from boa_tpu.engine.evaluation import evaluate_folder_arrays as ref_eval
    from boa_tpu_torch.engine.evaluation import evaluate_folder_arrays

    r = np.random.default_rng(31)
    refs, preds = {}, {}
    for i in range(2):
        a = r.integers(0, 9, (30, 24, 20)).astype(np.uint8)
        b = a.copy()
        b[r.random(a.shape) < 0.3] = r.integers(0, 9)
        refs[f"c{i}"], preds[f"c{i}"] = a, b
    for labels in (list(range(1, 9)) + [12], [1, (2, 3), 4]):
        got = evaluate_folder_arrays(refs, preds, labels, ignore_label)
        want = ref_eval(refs, preds, labels, ignore_label)
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
