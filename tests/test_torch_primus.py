"""The port's Primus ViT and its trainers against the reference on the CPU:
the forward in float32 at rtol = atol = 1e-4 (the shapes of
`tests/test_primus_io.py`, the position embedding resized up and down, the
head's flip), the variant table, `primus_train_config` and `apply_variant`
on every Primus name field by field, one AdamW step against `adamw_update`
on the same gradients (1e-5), a whole float32 train step against the
reference's, the carry-across round trip and checkpoints, and the
`run_training` refusal both packages share."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boa_tpu.models import primus as rp
from boa_tpu.train import optim as ro
from boa_tpu_torch.models import primus as pp
from boa_tpu_torch.weights.convert import _flatten, params_to_numpy

FWD_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(**kw):
    base = dict(embed_dim=32, depth=2, num_heads=4, patch_size=(4, 4, 4), num_classes=3)
    base.update(kw)
    return rp.PrimusConfig(**base), pp.PrimusConfig(**base)


def _ref_tree(cfg, grid, seed=0):
    params = rp.init_primus(jax.random.PRNGKey(seed), cfg, grid=grid)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    # a non-zero head bias and norm affine, so that each leaf shows in the output
    r = np.random.default_rng(seed)
    tree["head_b"] = r.normal(size=tree["head_b"].shape).astype(np.float32)
    tree["out_norm_scale"] = (1 + 0.1 * r.normal(size=tree["out_norm_scale"].shape)
                              ).astype(np.float32)
    return tree


def _leaves(tree) -> dict:
    out: dict = {}
    _flatten(tree, "", out)
    return out


@pytest.mark.parametrize("grid,shape", [
    ((4, 4, 4), (2, 16, 16, 16, 1)),   # the init grid
    ((4, 4, 4), (1, 8, 16, 8, 1)),     # downsampled to (2, 4, 2) tokens
    ((2, 2, 2), (1, 16, 16, 16, 1)),   # upsampled to (4, 4, 4)
    ((4, 4, 4), (1, 24, 12, 32, 1)),   # up and down at once
])
def test_forward_matches_reference(grid, shape):
    rcfg, cfg = _cfgs()
    tree = _ref_tree(rcfg, grid)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = np.asarray(rp.primus_forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), rcfg))
    model = pp.primus_params_from_numpy(tree, cfg, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == shape[:4] + (3,)
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_head_flip_and_two_channels():
    """A patch of (2, 4, 8) and two input channels: the head kernel is
    flipped in x, y and z on the way into ConvTranspose3d, and without the
    flip the output differs."""
    rcfg, cfg = _cfgs(patch_size=(2, 4, 8), input_channels=2, num_classes=4)
    tree = _ref_tree(rcfg, (4, 2, 2), seed=3)
    x = np.random.default_rng(2).normal(size=(1, 8, 8, 16, 2)).astype(np.float32)
    want = np.asarray(rp.primus_forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), rcfg))
    model = pp.primus_params_from_numpy(tree, cfg, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, **FWD_TOL)
        unflipped = torch.tensor(tree["head_w"]).permute(3, 4, 0, 1, 2)
        model.head.weight.copy_(unflipped)
        wrong = model(torch.from_numpy(x)).numpy()
    assert np.abs(wrong - want).max() > 1e-2


def test_resize_weights_match_jax():
    """The position-embedding resize, both directions and the identity."""
    r = np.random.default_rng(4)
    for src, dst in (((4, 4, 4), (2, 4, 2)), ((2, 3, 4), (8, 6, 5)), ((5, 5, 5), (3, 7, 5))):
        pos = r.normal(size=src + (6,)).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(pos), dst + (6,), "trilinear"))
        got = pp.resize_pos(torch.from_numpy(pos), dst).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_init_tree_runs_in_reference():
    """The port's numpy init has the reference's pytree: the reference's
    forward takes it and agrees with the port's module."""
    rcfg, cfg = _cfgs()
    tree = pp.init_primus(5, cfg, (4, 4, 4))
    ref = rp.init_primus(jax.random.PRNGKey(0), rcfg, grid=(4, 4, 4))
    assert jax.tree.structure(jax.tree.map(np.asarray, ref)) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(tree)):
        assert a.shape == b.shape
    x = np.random.default_rng(6).normal(size=(1, 16, 16, 16, 1)).astype(np.float32)
    want = np.asarray(rp.primus_forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), rcfg))
    with torch.no_grad():
        got = pp.primus_params_from_numpy(tree, cfg, device="cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_carry_across_round_trip(tmp_path):
    """pytree -> module -> pytree is exact, and a Primus trainer's
    checkpoint loads in a fresh trainer bit for bit."""
    from boa_tpu_torch.train.trainer import TrainConfig, Trainer

    rcfg, cfg = _cfgs()
    tree = _ref_tree(rcfg, (4, 4, 4))
    back = params_to_numpy(pp.primus_params_from_numpy(tree, cfg, device="cpu"))
    a, b = _leaves(tree), _leaves(back)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    tcfg = TrainConfig(arch=cfg, compute_dtype="float32", optimizer="adamw",
                       adam_betas=(0.9, 0.98), weight_decay=5e-2)
    tr = Trainer(tcfg, tmp_path / "a", seed=3, device="cpu")
    y = np.random.default_rng(0).integers(0, 3, (1, 8, 8, 8))
    x = (y[..., None] + np.random.default_rng(1).normal(0, .5, (1, 8, 8, 8, 1))).astype(np.float32)
    tr._step(tr.state.model, tr.state.optimizer, torch.from_numpy(x), torch.from_numpy(y), 3e-4)
    tr.save_checkpoint(tmp_path / "ck.pkl")
    tr2 = Trainer(tcfg, tmp_path / "b", seed=4, device="cpu")
    tr2.load_checkpoint(tmp_path / "ck.pkl")
    from boa_tpu_torch.train.optim import opt_state_to_numpy

    for one, two in ((params_to_numpy(tr.state.model),
                      params_to_numpy(tr2.state.model)),
                     (opt_state_to_numpy(tr.state.model, tr.state.optimizer),
                      opt_state_to_numpy(tr2.state.model, tr2.state.optimizer))):
        a, b = _leaves(one), _leaves(two)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_variants_table_matches_reference():
    assert pp.PRIMUS_VARIANTS == rp.PRIMUS_VARIANTS
    for v in pp.PRIMUS_VARIANTS:
        got = dataclasses.asdict(pp.primus_config(v, num_classes=5, input_channels=2))
        want = dataclasses.asdict(rp.primus_config(v, num_classes=5, input_channels=2))
        assert got == want
        assert pp.primus_config(v, 5).head_dim == rp.primus_config(v, 5).head_dim


def test_primus_train_config_matches_reference():
    from boa_tpu.train.variants import VARIANTS
    from boa_tpu.train.variants import apply_variant as ref_apply
    from boa_tpu.train.variants import primus_train_config as ref_ptc
    from boa_tpu_torch.train.variants import apply_variant, primus_train_config

    names = [n for n, s in VARIANTS.items() if s.primus]
    assert len(names) == 6
    for name in names:
        for bs in (2, 3):
            got, spec = primus_train_config(name, 7, input_channels=2, num_epochs=10,
                                            iters_per_epoch=5, batch_size=bs)
            want, rspec = ref_ptc(name, 7, input_channels=2, num_epochs=10,
                                  iters_per_epoch=5, batch_size=bs)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), name
            assert dataclasses.asdict(spec) == dataclasses.asdict(rspec)
            # apply_variant on a Primus config is the same recipe
            again, _ = apply_variant(got, name, batch_size=bs)
            ref_again, _ = ref_apply(want, name, batch_size=bs)
            assert dataclasses.asdict(again) == dataclasses.asdict(ref_again)
    with pytest.raises(ValueError, match="not a Primus"):
        primus_train_config("nnUNetTrainer", 3)


def _step_inputs(seed=0):
    r = np.random.default_rng(seed)
    y = r.integers(0, 3, (2, 8, 8, 8)).astype(np.int32)
    x = (y[..., None] + r.normal(0, 0.5, (2, 8, 8, 8, 1))).astype(np.float32)
    return x, y


def test_adamw_step_matches_adamw_update():
    """torch's AdamW (the Primus recipe) against the reference's
    `adamw_update`, from the same parameters on the same gradients."""
    from boa_tpu_torch.train.optim import make_optimizer
    from boa_tpu_torch.weights.convert import param_codecs

    rcfg, cfg = _cfgs()
    tree = _ref_tree(rcfg, (2, 2, 2))
    model = pp.primus_params_from_numpy(tree, cfg, device="cpu")
    opt = make_optimizer("adamw", model.parameters(), 3e-4, weight_decay=5e-2,
                         betas=(0.9, 0.98))
    params = jax.tree.map(jnp.asarray, tree)
    state = ro.init_adamw_state(params)
    r = np.random.default_rng(9)
    for _ in range(2):
        grads = jax.tree.map(lambda a: r.normal(size=a.shape).astype(np.float32), tree)
        for path, p, _, from_np in param_codecs(model):
            g = grads
            for k in path:
                g = g[k]
            p.grad = from_np(g, p)
        opt.step()
        params, state = ro.adamw_update(params, jax.tree.map(jnp.asarray, grads), state, 3e-4,
                                        betas=(0.9, 0.98), weight_decay=5e-2)
    got, want = _leaves(params_to_numpy(model)), _leaves(
        jax.tree.map(np.asarray, params))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_train_step_matches_reference():
    """A whole float32 Primus step (Dice + CE on the one head, the clip at 1,
    AdamW) against the reference's `make_train_step`."""
    from boa_tpu.train.trainer import TrainConfig as RefCfg
    from boa_tpu.train.trainer import make_train_step as ref_step
    from boa_tpu_torch.train.optim import make_optimizer
    from boa_tpu_torch.train.trainer import TrainConfig, make_train_step

    rcfg, cfg = _cfgs()
    tree = _ref_tree(rcfg, (2, 2, 2), seed=2)
    kw = dict(compute_dtype="float32", optimizer="adamw", adam_betas=(0.9, 0.98),
              weight_decay=5e-2, grad_clip=1.0)
    x, y = _step_inputs()
    params = jax.tree.map(jnp.asarray, tree)
    rp_, _, m = ref_step(RefCfg(arch=rcfg, **kw), donate=False)(
        params, ro.init_adamw_state(params), jnp.asarray(x), jnp.asarray(y), jnp.float32(3e-4))
    model = pp.primus_params_from_numpy(tree, cfg, device="cpu")
    opt = make_optimizer("adamw", model.parameters(), 3e-4, weight_decay=5e-2,
                         betas=(0.9, 0.98))
    got = make_train_step(TrainConfig(arch=cfg, **kw))(
        model, opt, torch.from_numpy(x), torch.from_numpy(y).long(), 3e-4)
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(m["grad_norm"]), rtol=1e-4)
    # The key bias's exact gradient is 0 (the softmax over keys is invariant to
    # a shift shared by every key), so both packages' float32 gradients there
    # are rounding noise, which Adam's first step (lr * g / (|g| + eps)) turns
    # into +-lr either way: held to |step| <= lr; every other leaf to 1e-4.
    a, b = _leaves(params_to_numpy(model)), _leaves(jax.tree.map(np.asarray, rp_))
    d = cfg.embed_dim
    for k in b:
        got, want = a[k], b[k]
        if k.endswith("qkv_b"):
            assert np.abs(got[d:2 * d] - tree["blocks"][int(k.split("/")[1])]["qkv_b"][d:2 * d]
                          ).max() <= 3e-4 * (1 + 1e-5)
            got, want = np.delete(got, np.s_[d:2 * d]), np.delete(want, np.s_[d:2 * d])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=k)


def test_build_trainer_primus_matches_reference(tmp_path):
    """`build_trainer` with a Primus name builds the ViT and its recipe, as
    the reference's; `Trainer.train_epoch` runs it."""
    from boa_tpu.train.run_training import build_trainer as ref_build
    from boa_tpu_torch.train.run_training import build_trainer

    name = "nnUNet_Primus_S_Trainer"
    mine, _, spec = build_trainer(tmp_path / "a", (16, 16, 16), 3, epochs=2, iters=1,
                                  trainer_name=name, device="cpu", compute_dtype="float32")
    ref, _, rspec = ref_build(tmp_path / "b", (16, 16, 16), 3, epochs=2, iters=1,
                              trainer_name=name, compute_dtype="float32")
    assert dataclasses.asdict(mine.cfg) == dataclasses.asdict(ref.cfg)
    assert dataclasses.asdict(spec) == dataclasses.asdict(rspec)
    assert isinstance(mine.state.model, pp.Primus)
    assert isinstance(mine.state.optimizer, torch.optim.AdamW)
    r = np.random.default_rng(3)
    y = r.integers(0, 3, (2, 16, 16, 16))
    x = (y[..., None] + r.normal(0, 0.5, (2, 16, 16, 16, 1))).astype(np.float32)
    logs = mine.train_epoch(iter([(x, y)]), n_iters=1)
    assert np.isfinite(logs["loss"]) and logs["epoch"] == 0


def test_run_training_refuses_primus_like_reference(tmp_path):
    """The reference's run_training cannot take a Primus trainer (its
    export_meta.json reads arch.features_per_stage); the port's says so
    before any work."""
    from boa_tpu.train.run_training import run_training as ref_run
    from boa_tpu_torch.train.dataset import CaseStore
    from boa_tpu_torch.train.run_training import run_training

    st = CaseStore(tmp_path / "cases")
    r = np.random.default_rng(0)
    for i in range(2):
        seg = np.zeros((16, 16, 16), np.int8)
        seg[4:10, 4:10, 4:10] = 1
        st.save_case(f"c{i}", (seg + r.normal(size=seg.shape) * 0.3).astype(np.float32)[None],
                     seg, properties={"spacing": [2.0, 2.0, 2.0]})
    kw = dict(patch=(16, 16, 16), batch_size=2, epochs=1, iters=1,
              trainer_name="nnUNet_Primus_S_Trainer")
    with pytest.raises(AttributeError, match="features_per_stage"):
        ref_run(st.root, tmp_path / "ref", **kw)
    with pytest.raises(ValueError, match="Primus"):
        run_training(st.root, tmp_path / "mine", device="cpu", **kw)
    assert not (tmp_path / "mine").exists()
