"""The port's multi-device layer (`boa_tpu_torch/parallel/`) against the
reference's on the CPU. The reference's meshes run on the conftest's 8
virtual CPU devices; the port's are groups of 2 and 4 spawned ranks on gloo,
each group joined with a timeout, one group per rank count (the checks of
one count share it). Rendezvous through a `file://` path under the test's
temporary directory, so xdist workers never share a port.

Held: `default_mesh_shape` for 1-16 devices; the multihost layout of 2 hosts
x (1, 2, 2) against the reference's device ids; the parameter rules against
`_param_spec` by meaning; `pad_starts_for_mesh`; with 2 ranks the sharded
logits against the reference's at 2e-3 and the chunked labels equal, with 4
ranks the z-slab logits at 2e-3; the dp = 2 step's loss within 1e-4
relative of the reference's dp mesh step; tp = 2 and sp = 2 steps against
the port's single-process step (loss 1e-4 relative, parameters 1e-5);
pretrained weights loaded over tp = 2 equal to one process's; a dp rank's
part of the loader's and the augmentations' batches equal to its rows of
the whole batch; and `python -m boa_tpu_torch.parallel.dryrun --n 2
--device cpu`."""

import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests import torch_parallel_ranks as ranks
from boa_tpu.inference.sliding_window import stack_fold_params
from boa_tpu.models.unet import ArchConfig as RefArch
from boa_tpu.models.unet import init_unet
from boa_tpu.ops import preprocess as rpp
from boa_tpu.parallel import mesh as rmesh
from boa_tpu.parallel import sharded_inference as rsi
from boa_tpu_torch.parallel import mesh as pmesh
from boa_tpu_torch.parallel import sharded_inference as psi
from boa_tpu_torch.weights.convert import _flatten

ROOT = Path(__file__).resolve().parents[1]
STEPS = {"dp": (2, 1, 1), "sp": (1, 2, 1), "tp": (1, 1, 2)}


def _ref_arch(feats=(4, 8), n_cls=3, ds=True):
    n = len(feats)
    return RefArch(n_stages=n, features_per_stage=tuple(feats), kernel_sizes=((3, 3, 3),) * n,
                   strides=((1, 1, 1),) + ((2, 2, 2),) * (n - 1), n_conv_per_stage=(2,) * n,
                   n_conv_per_stage_decoder=(2,) * (n - 1), num_classes=n_cls,
                   input_channels=1, deep_supervision=ds)


def _np_tree(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _leaves(tree) -> dict:
    out: dict = {}
    _flatten(tree, "", out)
    return out


def _batch(seed=0, n=2, size=8):
    r = np.random.default_rng(seed)
    y = r.integers(0, 3, (n, size, size, size)).astype(np.int64)
    x = (y[..., None] + r.normal(0, 0.5, (n, size, size, size, 1))).astype(np.float32)
    return x, y


def _inference_case():
    cfg = _ref_arch(n_cls=4, ds=False)
    params = [_np_tree(init_unet(jax.random.PRNGKey(k), cfg)) for k in range(2)]
    vol = np.random.default_rng(0).normal(size=(1, 24, 20, 18)).astype(np.float32)
    patch = (16, 16, 16)
    return cfg, params, vol, rpp.tile_starts(vol.shape[1:], patch, 0.5), \
        rpp.gaussian_importance_map(patch)


def _case_store(root):
    from boa_tpu_torch.train.dataset import CaseStore

    st = CaseStore(root)
    r = np.random.default_rng(13)
    for i in range(3):
        seg = np.zeros((20, 18, 16), np.int8)
        seg[4:12, 4:12, 4:12] = 1
        seg[12:18, 8:16, 6:14] = 2
        st.save_case(f"case_{i}", (seg * 1.5 + r.normal(size=seg.shape) * 0.3)
                     .astype(np.float32), seg, properties={"spacing": [2.0, 2.0, 2.0]})
    return st.root


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One group of 2 ranks runs every 2-rank check; with the inputs."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    ref_cfg = _ref_arch()
    tree = _np_tree(init_unet(jax.random.PRNGKey(1), ref_cfg))
    ckpt = tmp / "start.pkl"
    ckpt.write_bytes(pickle.dumps({
        "params": tree, "momentum_buf": jax.tree.map(np.zeros_like, tree), "epoch": 0,
        "best_ema": -1.0, "ema_dice": None, "logs": []}))
    x, y = _batch()
    arch = ranks.small_arch()
    icfg, iparams, vol, starts, gauss = _inference_case()
    from boa_tpu_torch.models.primus import PrimusConfig

    primus = PrimusConfig(embed_dim=32, depth=2, num_heads=4, patch_size=(4, 4, 4),
                          num_classes=3)
    cases = _case_store(tmp / "cases")
    train_kw = dict(patch=(16, 16, 16), batch_size=2, epochs=1, iters=2, fold=0,
                    validate=True, features=(4, 8), device="cpu", compute_dtype="float32")
    jobs = {"arch": arch, "x": x, "y": y, "out_dir": str(tmp / "out"),
            "checkpoint": str(ckpt), "steps": STEPS, "primus": primus,
            "run_training": {"cases": str(cases), "out": str(tmp / "train_mesh"),
                             "kw": train_kw},
            "inference": {"params": iparams, "arch": ranks.small_arch(num_classes=4,
                                                                      deep_supervision=False),
                          "vol": vol, "starts": starts, "gauss": gauss}}
    results = pmesh.spawn_ranks(ranks.two_rank_suite, 2, (jobs,), device="cpu",
                                init_method=f"file://{tmp / 'rendezvous'}", timeout=240)
    single = ranks.train_step(0, None, arch, x, y, str(tmp / "single"), checkpoint=str(ckpt))
    primus_single = ranks.train_step(0, None, primus, x, y, str(tmp / "primus"))
    train_single = ranks.run_training(None, {"cases": str(cases), "out": str(tmp / "train"),
                                             "kw": train_kw})
    return {"results": results, "single": single, "tree": tree, "ref_cfg": ref_cfg,
            "checkpoint": str(ckpt),
            "primus_single": primus_single, "train_single": train_single,
            "x": x, "y": y, "inference": (icfg, iparams, vol, starts, gauss)}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("four_ranks")
    cfg = _ref_arch(n_cls=4, ds=False)
    params = [_np_tree(init_unet(jax.random.PRNGKey(7), cfg))]
    vol = np.random.default_rng(1).normal(size=(1, 20, 18, 40)).astype(np.float32)
    gauss = rpp.gaussian_importance_map((16, 16, 16))
    jobs = {"zslab": {"params": params, "arch": ranks.small_arch(num_classes=4,
                                                                 deep_supervision=False),
                      "vol": vol, "gauss": gauss}}
    results = pmesh.spawn_ranks(ranks.four_rank_suite, 4, (jobs,), device="cpu",
                                init_method=f"file://{tmp / 'rendezvous'}", timeout=240)
    return {"results": results, "cfg": cfg, "params": params, "vol": vol, "gauss": gauss}


# ---------------------------------------------------------------- no ranks
@pytest.mark.parametrize("n", range(1, 17))
def test_default_mesh_shape_matches_reference(n):
    assert pmesh.default_mesh_shape(n) == rmesh.default_mesh_shape(n)


def test_multihost_layout_matches_reference():
    ref = rmesh.make_multihost_mesh(n_hosts=2, ici_shape=(1, 2, 2))
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    got = pmesh.multihost_layout(8, (1, 2, 2), 2)
    np.testing.assert_array_equal(got, ids)
    assert got.shape == tuple(ref.shape.values())
    with pytest.raises(ValueError):
        pmesh.multihost_layout(8, (1, 2, 2), 3)


def test_pad_starts_matches_reference():
    starts = np.arange(21).reshape(7, 3).astype(np.int32)
    for n in (1, 2, 3, 4, 8):
        got, gv = psi.pad_starts_for_mesh(starts, n)
        want, wv = rsi.pad_starts_for_mesh(starts, n)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(gv, wv)


def test_mesh_needs_a_process_group():
    with pytest.raises(ValueError, match="initialize_distributed"):
        pmesh.make_mesh(2)


# ---------------------------------------------------------------- 2 ranks
def test_param_rules_match_reference_by_meaning(two_ranks):
    """A parameter is tp-sharded where the reference's `_param_spec` shards
    its leaf, on the axis that means the same: a conv's and a norm's output
    channels. The reference shards a transposed conv's kernel on its last
    axis, which in its (k, k, k, co, ci) leaf is the input channels; the
    port shards the output channels (torch dim 1) of every transposed conv
    whose extent divides by tp."""
    from boa_tpu_torch.weights.convert import param_leaves, params_from_numpy, tree_get

    rules = two_ranks["results"][0]["rules"]
    assert rules == two_ranks["results"][1]["rules"]
    tree = two_ranks["tree"]
    model = params_from_numpy(tree, ranks.small_arch(), device="cpu")
    names = {id(p): n for n, p in model.named_parameters()}
    seen = 0
    for path, p in param_leaves(model):
        spec = rmesh._param_spec(tuple(jax.tree_util.DictKey(k) if isinstance(k, str) else
                                       jax.tree_util.SequenceKey(k) for k in path),
                                 tree_get(tree, path), 2)
        port = rules["params"][names[id(p)]]
        assert port[:2] == ["R", "R"]          # dp and sp replicate parameters
        if path[-2:] == ("transp", "w"):
            want = "S(1)" if p.shape[1] % 2 == 0 else "R"
        elif "tp" in tuple(spec):
            want = "S(0)"                        # the leaf's last axis is torch dim 0
        else:
            want = "R"
        assert port[2] == want, (path, port, spec)
        seen += 1
    assert seen == len(rules["params"])
    assert rules["batch"] == ["S(0)", "S(3)", "R"] and rules["label"] == rules["batch"]
    assert rules["replicated"] == ["R", "R", "R"] and rules["spatial"] == ["R", "S(3)", "R"]


def test_dp_step_matches_reference_dp_mesh(two_ranks):
    """dp = 2: the global loss (batch dice over both ranks' rows) equals the
    reference's GSPMD step over a (2, 1, 1) mesh, and the parameters after
    the step the port's one-process step."""
    from boa_tpu.train.optim import init_sgd_state
    from boa_tpu.train.trainer import TrainConfig as RefCfg
    from boa_tpu.train.trainer import make_train_step

    tree, x, y = two_ranks["tree"], two_ranks["x"], two_ranks["y"]
    params = jax.tree.map(jnp.asarray, tree)
    cfg = RefCfg(arch=two_ranks["ref_cfg"], compute_dtype="float32")
    mesh = rmesh.make_mesh(2, ("dp", "sp", "tp"), (2, 1, 1))
    ps = rmesh.param_shardings(mesh, params)
    xs, ys = rmesh.batch_sharding(mesh), rmesh.label_sharding(mesh)
    step = make_train_step(cfg, in_shardings=(ps, ps, xs, ys, None), donate=False)
    with mesh:
        _, _, m = step(jax.device_put(params, ps), jax.device_put(init_sgd_state(params), ps),
                       jax.device_put(jnp.asarray(x), xs),
                       jax.device_put(jnp.asarray(y.astype(np.int32)), ys), jnp.float32(1e-2))
    got = two_ranks["results"]
    assert got[0]["steps"]["dp"]["loss"] == got[1]["steps"]["dp"]["loss"]
    np.testing.assert_allclose(got[0]["steps"]["dp"]["loss"], float(m["loss"]), rtol=1e-4)
    _close_to_single(two_ranks, "dp")


def _close_to_single(two_ranks, name):
    single = two_ranks["single"]
    got = two_ranks["results"][0]["steps"][name]
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], single["grad_norm"], rtol=1e-4)
    a, b = _leaves(got["params"]), _leaves(single["params"])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5, err_msg=k)


def test_tp_step_matches_single_process(two_ranks):
    """tp = 2: every conv's output channels split over the ranks."""
    _close_to_single(two_ranks, "tp")


def test_sp_step_matches_single_process(two_ranks):
    """sp = 2: two z-slabs of 4 slices with halos and global norms."""
    _close_to_single(two_ranks, "sp")


def test_primus_trains_over_dp_only(two_ranks):
    """Primus over dp = 2 is the one-process step; over tp it is refused."""
    got = two_ranks["results"][0]["primus_dp"]
    single = two_ranks["primus_single"]
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-4)
    a, b = _leaves(got["params"]), _leaves(single["params"])
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5, err_msg=k)
    assert "dp only" in two_ranks["results"][0]["primus_tp"]


def test_run_training_over_dp_matches_one_process(two_ranks):
    """`run_training` with a (2, 1, 1) mesh: each rank loads and augments
    only its rows of every global batch (the whole batch's draws) and trains
    on them; rank 0 writes the run's files; the loss, the pseudo dice and
    the final checkpoint are the one-process run's."""
    got = [r["run_training"] for r in two_ranks["results"]]
    single = two_ranks["train_single"]
    assert got[0]["loss"] == got[1]["loss"]
    np.testing.assert_allclose(got[0]["loss"], single["loss"], rtol=1e-4)
    np.testing.assert_allclose(got[0]["dice"], single["dice"], rtol=1e-4, atol=1e-6)
    assert got[0]["validation"] and got[0]["files"] == single["files"]
    a, b = _leaves(got[0]["params"]), _leaves(single["params"])
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5, err_msg=k)


def test_pretrained_weights_load_over_tp(two_ranks, tmp_path):
    """`--pretrained_weights` on a tp = 2 trainer: loaded into the whole
    network, then sharded; gathered, it is one process's."""
    got = two_ranks["results"][0]["pretrained_tp"]
    assert got["sharded"] > 0
    single = ranks.pretrained(0, None, ranks.small_arch(), two_ranks["checkpoint"],
                              str(tmp_path))
    a, b = _leaves(got["params"]), _leaves(single["params"])
    want = _leaves(two_ranks["tree"])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        if not k.startswith("seg_heads"):   # the heads stay fresh
            np.testing.assert_array_equal(a[k], want[k], err_msg=k)


@pytest.mark.parametrize("kw", [{}, {"probabilistic_oversampling": True},
                                {"cascade": True, "cascade_cc_dropout_p": 1.0}],
                         ids=["round_rule", "probabilistic", "cascade"])
def test_loader_parts_make_the_whole_batch(tmp_path, kw):
    """`DataLoader(part=(i, 2))` yields rows i of the whole batch, bit for
    bit, batch after batch."""
    from boa_tpu_torch.train.dataloader import DataLoader
    from boa_tpu_torch.train.dataset import CaseStore

    store = CaseStore(_case_store(tmp_path / "cases"))
    for cid in store.case_ids():
        store.save_prev_seg(cid, np.roll(np.asarray(store.load_case(cid).seg), 3, axis=0))
    whole = DataLoader(store, (8, 8, 8), 4, seed=3, **kw)
    parts = [DataLoader(store, (8, 8, 8), 4, seed=3, part=(i, 2), **kw) for i in range(2)]
    for _ in range(3):
        want = whole.next_batch()
        got = [q.next_batch() for q in parts]
        for j, a in enumerate(want):
            np.testing.assert_array_equal(np.concatenate([g[j] for g in got]), a)
    with pytest.raises(ValueError):
        DataLoader(store, (8, 8, 8), 3, part=(0, 2))


@pytest.mark.parametrize("name", ["augment_batch", "augment_batch_da5",
                                  "augment_batch_cascade"])
def test_augment_parts_make_the_whole_batch(name):
    """Each part of a batch augmented with `part=(i, 2)` from the same
    generator state is its rows of the whole batch augmented at once."""
    import torch

    from boa_tpu_torch.train import augment as pa

    r = np.random.default_rng(4)
    x = torch.from_numpy(r.normal(size=(4, 12, 12, 10, 1)).astype(np.float32))
    y = torch.from_numpy(r.integers(0, 3, (4, 12, 12, 10)).astype(np.int64))
    fn = getattr(pa, name)

    def run(xs, ys, part):
        gen = torch.Generator().manual_seed(9)
        if name == "augment_batch_cascade":
            return fn(gen, xs, ys, (ys + 1) % 3, (1, 2), mirror_axes=(0, 1, 2), part=part)
        return fn(gen, xs, ys, mirror_axes=(0, 1, 2), part=part)

    want = run(x, y, None)
    got = [run(x[2 * i:2 * i + 2], y[2 * i:2 * i + 2], (i, 2)) for i in range(2)]
    for j in range(2):
        torch.testing.assert_close(torch.cat([g[j] for g in got]), want[j], rtol=0, atol=0)


def test_sharded_logits_match_reference(two_ranks):
    cfg, params, vol, starts, gauss = two_ranks["inference"]
    mesh = rmesh.make_mesh(2, ("dp",), (2,))
    want = np.asarray(rsi.sliding_window_logits_sharded(
        stack_fold_params([jax.tree.map(jnp.asarray, p) for p in params]), jnp.asarray(vol),
        starts, gauss, cfg, mesh, compute_dtype=jnp.float32))
    got = [r["logits"] for r in two_ranks["results"]]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], want, rtol=2e-3, atol=2e-3)
    assert (got[0].argmax(0) == want.argmax(0)).mean() > 0.999


def test_sharded_chunked_labels_match_reference(two_ranks):
    cfg, params, vol, starts, gauss = two_ranks["inference"]
    mesh = rmesh.make_mesh(2, ("dp",), (2,))
    want = np.asarray(rsi.sliding_window_seg_sharded_chunked(
        stack_fold_params([jax.tree.map(jnp.asarray, p) for p in params]), jnp.asarray(vol),
        starts, gauss, cfg, mesh, compute_dtype=jnp.float32, accum_dtype=jnp.float32, k=2))
    got = [r["seg"] for r in two_ranks["results"]]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], want)


# ---------------------------------------------------------------- 4 ranks
def test_zslab_matches_reference(four_ranks):
    mesh = rmesh.make_mesh(4, ("dp",), (4,))
    want = np.asarray(rsi.sliding_window_logits_zslab(
        stack_fold_params([jax.tree.map(jnp.asarray, p) for p in four_ranks["params"]]),
        jnp.asarray(four_ranks["vol"]), four_ranks["gauss"], four_ranks["cfg"], mesh,
        compute_dtype=jnp.float32))
    slabs = [r["zslab"] for r in four_ranks["results"]]
    assert [s.shape[-1] for s in slabs] == [10, 10, 10, 10]
    np.testing.assert_allclose(np.concatenate(slabs, axis=-1), want, rtol=2e-3, atol=2e-3)


def test_mesh_layouts(four_ranks):
    """make_mesh lays ranks out in order; make_multihost_mesh puts the hosts
    on the outer dp axis, as the reference's device ids."""
    lay = [r["layouts"] for r in four_ranks["results"]]
    assert lay[0]["flat"] == [[[0]], [[1]], [[2]], [[3]]]
    assert lay[0]["mesh"] == [[[0, 1], [2, 3]]]
    assert [q["coord"] for q in lay] == [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1]]
    assert lay[0]["multihost"] == pmesh.multihost_layout(4, (1, 1, 2), 2).tolist()
    assert lay[0]["multihost_shape"] == [2, 1, 2]


# ---------------------------------------------------------------- the dry run
def test_dryrun_two_ranks_on_cpu():
    r = subprocess.run([sys.executable, "-m", "boa_tpu_torch.parallel.dryrun", "--n", "2",
                        "--device", "cpu", "--timeout", "240"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "dryrun_multichip(2): mesh dp=1 sp=1 tp=2 flagship 6-stage 32->320" in r.stdout
    assert " ok" in r.stdout
