"""Split-K of the port's wide-channel fused conv (K5, csrc/conv_in_act.cu)
on the CPU: the split plan at the fused forward's shapes, and the split
contract against the reference (boa_tpu/ops/pallas_conv.py, Pallas in
interpret mode). A split call's partial sums over its K ranges (input
channel chunks, or a chunk's dx tap planes), summed by the plain finishing
pass, must give the reference's y and sums at tests/test_torch_fused.py's
bars. The card-only checks of the kernel itself live in
tests/test_torch_kernels.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from boa_tpu.ops import pallas_conv as jpc
from boa_tpu_torch.ops import pallas_conv as pc

H100_SMS = 132

# the 17 K5 calls of one fused total_fast forward on a 128^3 tile:
# (extent, cin, cout), as chip_smoke.py's FUSED_CONVS
FUSED_CONVS = [
    (128, 1, 32), (128, 32, 32), (64, 64, 64), (32, 128, 128), (16, 256, 256),
    (8, 320, 320), (4, 320, 320), (8, 640, 320), (8, 320, 320), (16, 512, 256),
    (16, 256, 256), (32, 256, 128), (32, 128, 128), (64, 128, 64), (64, 64, 64),
    (128, 64, 32), (128, 32, 32),
]


@pytest.mark.parametrize("s,cin,cout", FUSED_CONVS)
def test_split_plan_at_the_fused_forward_shapes(s, cin, cout):
    splits, taps = pc._split_plan(s, s, s, cin, cout, H100_SMS)
    _, nch, bn, cout_p = pc._plan(cin, cout)
    units = nch * taps
    assert taps in (1, 3) and 1 <= splits <= units
    assert all(len(pc._split_units(k, splits, units)) >= 1 for k in range(splits))
    blocks = splits * pc._blocks(s, s, s, bn, cout_p)
    if s <= 32:  # the card is full, or every K unit has its own split
        assert blocks >= H100_SMS or splits == 3 * nch
    if s <= 16:
        assert splits > 1
    if s == 128:
        assert splits == 1
    if splits > 1:
        assert splits * s ** 3 * cout_p * 4 <= pc.SPLIT_WORKSPACE_BYTES
    assert blocks <= 2 * H100_SMS or splits == 1  # at most one wave of two per SM


@pytest.mark.parametrize("sms", [1, 8, 132, 1000])
def test_split_plan_bounds_the_workspace(sms):
    """Any card: splits within the K units, the workspace under its cap, and
    a split call never asks for more than two blocks per SM."""
    for s, cin, cout in FUSED_CONVS + [(32, 72, 40), (3, 1, 8), (64, 640, 320)]:
        splits, taps = pc._split_plan(s, s, s, cin, cout, sms)
        _, nch, bn, cout_p = pc._plan(cin, cout)
        assert 1 <= splits <= nch * taps
        assert splits == 1 or splits * s ** 3 * cout_p * 4 <= pc.SPLIT_WORKSPACE_BYTES
        assert splits == 1 or splits * pc._blocks(s, s, s, bn, cout_p) <= 2 * sms


def _inputs(cin, cout, seed):
    rng = np.random.default_rng(seed)
    shape = (6, 5, 8)
    x = rng.normal(size=(*shape, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.normal(size=cout) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 2.0, cin)
    nd = {"mean": rng.normal(size=cin), "inv_std": 1.0 / np.sqrt(var + 1e-5),
          "gamma": rng.normal(size=cin), "beta": rng.normal(size=cin)}
    return x, w, b, {k: v.astype(np.float32) for k, v in nd.items()}


@functools.lru_cache(maxsize=None)
def _reference(cin, cout, seed):
    x, w, b, nd = _inputs(cin, cout, seed)
    nj = jpc.NormAct(**{k: jnp.asarray(v) for k, v in nd.items()}, slope=0.01)
    yj, sj = jpc.conv3d_in_act(jnp.asarray(x), nj, jnp.asarray(w), jnp.asarray(b),
                               slope=0.01, out_dtype=jnp.float32, interpret=True)
    return np.asarray(yj), np.asarray(sj)


@pytest.mark.parametrize("split", ["one", "two", "chunks", "planes", "two planes"])
@pytest.mark.parametrize("cin,cout", [(40, 48), (72, 40)])
def test_split_partials_finished_match_reference(cin, cout, split):
    """cin 40 and 72 are not whole chunks of 32: the last chunk is ragged.
    Splits 1, 2, one per chunk, and the most (one per dx tap plane)."""
    nch = pc._plan(cin, cout)[1]
    splits, taps = {"one": (1, 1), "two": (2, 1), "chunks": (nch, 1),
                    "planes": (3 * nch, 3), "two planes": (2, 3)}[split]
    x, w, b, nd = _inputs(cin, cout, cin + cout)
    nt = pc.NormAct(**{k: torch.from_numpy(v) for k, v in nd.items()}, slope=0.01)
    parts = pc.split_partials_plain(torch.from_numpy(x), nt, torch.from_numpy(w),
                                    slope=0.01, splits=splits, taps=taps)
    assert parts.shape == (splits, *x.shape[:3], cout) and parts.dtype == torch.float32
    y, s = pc.finish_plain(parts, torch.from_numpy(b), torch.float32)
    yj, sj = _reference(cin, cout, cin + cout)
    assert y.shape == yj.shape and s.shape == sj.shape
    assert np.abs(y.numpy() - yj).max() <= 1e-3 * np.abs(yj).max()
    assert np.abs(s.numpy() - sj).max() <= 1e-3 * np.abs(sj[1]).max()


def test_finish_plain_adds_the_bias_once_and_squares_the_sum():
    """Two partials that cancel: y is the bias alone, and sum y^2 is taken
    from the summed y, not from the partials' squares."""
    p = torch.randn(2, 3, 4, 5, 8, generator=torch.Generator().manual_seed(0))
    parts = torch.stack([p[0], -p[0]])
    b = torch.arange(8, dtype=torch.float32)
    y, s = pc.finish_plain(parts, b, torch.float32)
    assert torch.equal(y, b.expand(3, 4, 5, 8))
    assert torch.allclose(s[0], 60 * b) and torch.allclose(s[1], 60 * b * b)
    yb, _ = pc.finish_plain(parts, b, torch.bfloat16)
    assert yb.dtype == torch.bfloat16 and torch.equal(yb.float(), y)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_split_plan_counts_the_batch(n):
    """A batch of n fills the card n times as much: no more splits than one
    sample takes, at most two blocks per SM in all, the workspace of all n
    samples under its cap; K1's 128^3 calls never split."""
    for s, cin, cout in FUSED_CONVS + [(16, 64, 32), (32, 32, 32), (128, 64, 32)]:
        splits, taps = pc._split_plan(s, s, s, cin, cout, H100_SMS, n)
        one, _ = pc._split_plan(s, s, s, cin, cout, H100_SMS)
        _, nch, bn, cout_p = pc._plan(cin, cout)
        assert 1 <= splits <= min(one, nch * taps) or (splits == 1 and one == 1)
        assert splits == 1 or n * splits * pc._blocks(s, s, s, bn, cout_p) <= 2 * H100_SMS
        assert splits == 1 or n * splits * s ** 3 * cout_p * 4 <= pc.SPLIT_WORKSPACE_BYTES
        if s == 128:
            assert splits == 1
