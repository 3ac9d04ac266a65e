"""Plain versions of the port's row-conv kernels against the reference
Pallas kernels (boa_tpu/ops/rowconv.py, interpret mode on the CPU).

The reference works on its (Z, X, C, Y) row layout with taps ordered
(dz, dx, dy); the port on channels-last (N, X, Y, Z, C) with (dx, dy, dz)
taps. Inputs are made once with numpy and transposed for each side. Bars
from tests/test_rowconv.py: outputs at rtol = atol = 2e-2, sums at rtol
2e-2 / atol 0.2. The card-only kernel-vs-plain checks live in
tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from boa_tpu.ops import rowconv as jrc
from boa_tpu_torch.ops import rowconv as rc


def _to_rows(a):      # port (X, Y, Z, C) -> reference (Z, X, C, Y)
    return np.transpose(a, (2, 0, 3, 1))


def _from_rows(a):    # reference (Z, X, C, Y) -> port (X, Y, Z, C)
    return np.transpose(a, (1, 3, 0, 2))


def _norm_np(rng, cin):
    return dict(mean=rng.normal(size=cin), inv_std=1.0 + rng.random(cin),
                gamma=1.0 + 0.1 * rng.normal(size=cin),
                beta=0.1 * rng.normal(size=cin))


def _norms(nd, slope):
    j = jrc.NormAct(**{k: jnp.asarray(v, jnp.float32) for k, v in nd.items()},
                    slope=slope)
    t = rc.NormAct(**{k: torch.tensor(v, dtype=torch.float32) for k, v in nd.items()},
                   slope=slope)
    return j, t


def _check(got_y, got_s, ref_y, ref_s):
    np.testing.assert_allclose(got_y, ref_y, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got_s, ref_s, rtol=2e-2, atol=2e-1)


@pytest.mark.parametrize("cin,cout,slope,bz,g4,X", [
    (32, 32, 0.01, 1, False, 16),
    (8, 16, 1.0, 1, False, 16),
    (8, 8, 0.01, 4, False, 16),
    (32, 32, 0.01, 2, True, 16),
    (8, 16, 1.0, 1, True, 16),
    (16, 8, "vector", 1, False, 16),
    (8, 8, 1.0, 1, False, 11),   # X not a multiple of the block: pad rows out of the sums
])
def test_conv3d_rows_plain_matches_reference(cin, cout, slope, bz, g4, X):
    rng = np.random.default_rng(cin * 100 + cout + X)
    Y, Z = 128, 6
    x = (rng.normal(size=(X, Y, Z, cin)) * 2.0 + 0.3).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = (rng.normal(size=cout) * 0.1).astype(np.float32)
    nd = _norm_np(rng, cin)
    if slope == "vector":
        s_np = np.concatenate([np.ones(cin // 2), np.full(cin - cin // 2, 0.01)])
        s_j, s_t = jnp.asarray(s_np, jnp.float32), torch.tensor(s_np, dtype=torch.float32)
        nj, nt = _norms(nd, 1.0)
    else:
        s_j = s_t = slope
        nj, nt = _norms(nd, slope)
    yj, sj = jrc.conv3d_rows(jnp.asarray(_to_rows(x)), nj,
                             jnp.asarray(np.transpose(w, (2, 0, 1, 3, 4))),
                             jnp.asarray(b), slope=s_j, out_dtype=jnp.float32,
                             interpret=True, bx=8, bz=bz, g4=g4)
    yt, st = rc.conv3d_rows(torch.from_numpy(x)[None], nt, torch.from_numpy(w),
                            torch.from_numpy(b), slope=s_t,
                            out_dtype=torch.float32)
    assert yt.shape == (1, X, Y, Z, cout) and st.shape == (1, 2, cout)
    _check(yt[0].numpy(), st[0].numpy(), _from_rows(np.asarray(yj)), np.asarray(sj))


def test_conv3d_rows_stride2_plain_matches_reference():
    rng = np.random.default_rng(5)
    X, Y, Z, cin, cout = 16, 128, 8, 8, 16
    x = rng.normal(size=(X, Y, Z, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = (rng.normal(size=cout) * 0.1).astype(np.float32)
    nj, nt = _norms(_norm_np(rng, cin), 0.01)
    yj, sj = jrc.conv3d_rows_stride2(
        jnp.asarray(_to_rows(x)), nj, jnp.asarray(np.transpose(w, (2, 0, 1, 3, 4))),
        jnp.asarray(b), slope=0.01, out_dtype=jnp.float32, interpret=True, bx2=4)
    yt, st = rc.conv3d_rows_stride2(torch.from_numpy(x)[None], nt,
                                    torch.from_numpy(w), torch.from_numpy(b),
                                    slope=0.01, out_dtype=torch.float32)
    assert yt.shape == (1, X // 2, Y // 2, Z // 2, cout)
    _check(yt[0].numpy(), st[0].numpy(), _from_rows(np.asarray(yj)), np.asarray(sj))


def test_transpconv2_rows_plain_matches_reference():
    rng = np.random.default_rng(6)
    X, Y, Z, cin, cout = 10, 64, 6, 16, 8
    x = rng.normal(size=(X, Y, Z, cin)).astype(np.float32)
    w = (rng.normal(size=(2, 2, 2, cin, cout)) * 0.3).astype(np.float32)  # (a=x, b=y, c=z)
    yj = jrc.transpconv2_rows(jnp.asarray(_to_rows(x)),
                              jnp.asarray(np.transpose(w, (2, 0, 1, 3, 4))),
                              out_dtype=jnp.float32, interpret=True, bx=4)
    yt = rc.transpconv2_rows(torch.from_numpy(x)[None], torch.from_numpy(w),
                             out_dtype=torch.float32)
    assert yt.shape == (1, 2 * X, 2 * Y, 2 * Z, cout)
    np.testing.assert_allclose(yt[0].numpy(), _from_rows(np.asarray(yj)),
                               rtol=2e-2, atol=2e-2)


def test_conv3d_rows_stride2_plain_on_a_channel_slice_matches_reference():
    """K2 reads the skip half of the decoder concat in place: its plain
    version on that channel slice matches the reference on the same values."""
    rng = np.random.default_rng(15)
    X, Y, Z, cin, cout = 10, 128, 6, 16, 32
    x = rng.normal(size=(X, Y, Z, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = (rng.normal(size=cout) * 0.1).astype(np.float32)
    nj, nt = _norms(_norm_np(rng, cin), 0.01)
    yj, sj = jrc.conv3d_rows_stride2(
        jnp.asarray(_to_rows(x)), nj, jnp.asarray(np.transpose(w, (2, 0, 1, 3, 4))),
        jnp.asarray(b), slope=0.01, out_dtype=jnp.float32, interpret=True, bx2=4)
    cat = torch.tensor(rng.normal(size=(1, X, Y, Z, 2 * cin)), dtype=torch.float32)
    cat[..., cin:] = torch.from_numpy(x)
    xs = cat[..., cin:]
    assert not xs.is_contiguous()
    yt, st = rc.conv3d_rows_stride2(xs, nt, torch.from_numpy(w), torch.from_numpy(b),
                                    slope=0.01, out_dtype=torch.float32)
    assert yt.shape == (1, X // 2, Y // 2, Z // 2, cout)
    _check(yt[0].numpy(), st[0].numpy(), _from_rows(np.asarray(yj)), np.asarray(sj))


def test_transpconv2_rows_plain_into_the_concat_matches_reference():
    """K3 with its bias writes the first cout channels of the decoder concat;
    the reference adds the bias and concatenates after its kernel. The plain
    version rounds once, the reference twice: within the bf16 bar."""
    rng = np.random.default_rng(16)
    X, Y, Z, cin, cout = 6, 64, 4, 32, 8
    x = rng.normal(size=(X, Y, Z, cin)).astype(np.float32)
    w = (rng.normal(size=(2, 2, 2, cin, cout)) * 0.3).astype(np.float32)
    b = rng.normal(size=cout).astype(np.float32)
    skip = rng.normal(size=(2 * X, 2 * Y, 2 * Z, cout)).astype(np.float32)
    up = jrc.transpconv2_rows(jnp.asarray(_to_rows(x)),
                              jnp.asarray(np.transpose(w, (2, 0, 1, 3, 4))),
                              out_dtype=jnp.bfloat16, interpret=True, bx=4)
    up = up + jnp.asarray(b).astype(jnp.bfloat16)[None, None, :, None]
    ref = jnp.concatenate([up[:, :, :cout], jnp.asarray(_to_rows(skip)).astype(jnp.bfloat16)],
                          axis=2)
    cat = torch.empty((1, 2 * X, 2 * Y, 2 * Z, 2 * cout), dtype=torch.bfloat16)
    cat[..., cout:] = torch.from_numpy(skip)
    skip_bits = cat[..., cout:].clone()
    got = rc.transpconv2_rows(torch.from_numpy(x)[None].to(torch.bfloat16),
                              torch.from_numpy(w), torch.from_numpy(b),
                              out=cat[..., :cout])
    assert got.data_ptr() == cat.data_ptr()
    assert torch.equal(cat[..., cout:].view(torch.int16), skip_bits.view(torch.int16))
    np.testing.assert_allclose(cat[0].float().numpy(),
                               _from_rows(np.asarray(ref.astype(jnp.float32))),
                               rtol=2e-2, atol=2e-2)


def test_conv3d_rows_plain_into_an_out_slice():
    """`out=` a channel slice: the same values as a fresh output, written
    there, the other channels untouched."""
    rng = np.random.default_rng(17)
    x = torch.tensor(rng.normal(size=(2, 5, 6, 7, 8)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(3, 3, 3, 8, 16)) * 0.2, dtype=torch.float32)
    b = torch.tensor(rng.normal(size=16), dtype=torch.float32)
    norm = rc.NormAct(**{k: torch.tensor(v, dtype=torch.float32)
                         for k, v in _norm_np(rng, 8).items()}, slope=0.01)
    want, want_s = rc.conv3d_rows(x, norm, w, b, slope=0.01)
    cat = torch.full((2, 5, 6, 7, 48), 5.0, dtype=torch.bfloat16)
    got, got_s = rc.conv3d_rows(x, norm, w, b, slope=0.01, out=cat[..., 16:32])
    assert got.data_ptr() == cat[..., 16:32].data_ptr()
    assert torch.equal(cat[..., 16:32], want) and torch.equal(got_s, want_s)
    assert bool((cat[..., :16] == 5.0).all()) and bool((cat[..., 32:] == 5.0).all())


def test_packed_weights_match_packing_per_call():
    """The wrappers give the same result with `w_packed` as with w and b,
    refuse weights packed for another kernel, and the packs unpack to the
    bf16-rounded weights."""
    rng = np.random.default_rng(18)
    x = torch.tensor(rng.normal(size=(1, 6, 4, 10, 24)), dtype=torch.float32)
    w3 = torch.tensor(rng.normal(size=(3, 3, 3, 24, 40)) * 0.2, dtype=torch.float32)
    w2 = torch.tensor(rng.normal(size=(2, 2, 2, 24, 12)) * 0.2, dtype=torch.float32)
    b3 = torch.tensor(rng.normal(size=40), dtype=torch.float32)
    b2 = torch.tensor(rng.normal(size=12), dtype=torch.float32)
    norm = rc.identity_normact(24)
    p1, p3, p2 = rc.pack_rows(w3, b3), rc.pack_conv(w3, b3), rc.pack_transp(w2, b2)
    for fn, p, other in ((rc.conv3d_rows, p1, p3), (rc.conv3d_rows_stride2, p3, p1)):
        y, s = fn(x, norm, w3, b3, slope=0.01)
        yp, sp = fn(x, norm, None, None, slope=0.01, w_packed=p)
        assert torch.equal(y, yp) and torch.equal(s, sp)
        with pytest.raises(ValueError):   # packed for the other kernel
            fn(x, norm, None, None, slope=0.01, w_packed=other)
    assert torch.equal(rc.transpconv2_rows(x, w2, b2),
                       rc.transpconv2_rows(x, None, w_packed=p2))
    for p, w, b, unpack in ((p1, w3, b3, rc.unpack_rows), (p3, w3, b3, rc.unpack_conv),
                            (p2, w2, b2, rc.unpack_transp)):
        wu, bu = unpack(p)
        assert torch.equal(wu, w.to(torch.bfloat16).float()) and torch.equal(bu, b)


@pytest.mark.parametrize("cin,cout", [(16, 8), (20, 32), (64, 64)])
def test_transp_weight_pack_is_the_mma_fragment_order(cin, cout):
    """K3's packed weights: per (a, b) pair the matrix W[ci][c*cout_p + co] =
    w[a, b, c, ci, co], in the m16n8k16 B register order of
    `test_conv_weight_pack_is_the_mma_fragment_order`."""
    w = torch.randn(2, 2, 2, cin, cout, generator=torch.Generator().manual_seed(cin))
    cin_p, cout_p = -(-cin // 16) * 16, next(c for c in (8, 16, 32, 64) if c >= cout)
    ncol = 2 * cout_p
    pk = rc.pack_transp(w, None).w.float().reshape(4, cin_p // 16, ncol // 16, 32, 8)
    got = torch.empty(4, cin_p, ncol)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(8):
            q, h, e = j // 4, (j // 2) % 2, j % 2
            for kc in range(cin_p // 16):
                for p in range(ncol // 16):
                    got[:, kc * 16 + 8 * h + 2 * t + e, p * 16 + 8 * q + g] = pk[:, kc, p, lane, j]
    want = torch.zeros(2, 2, cin_p, 2, cout_p)
    want[:, :, :cin, :, :cout] = w.to(torch.bfloat16).float().permute(0, 1, 3, 2, 4)
    assert torch.equal(got, want.reshape(4, cin_p, ncol))


def test_per_sample_sums_and_identity_norm():
    """A batch of two keeps its statistics per sample: each sample equals
    the same call on that sample alone."""
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.normal(size=(2, 6, 8, 10, 8)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(3, 3, 3, 8, 16)) * 0.2, dtype=torch.float32)
    nd = _norm_np(rng, 8)
    norm = rc.NormAct(mean=torch.tensor(np.stack([nd["mean"], -nd["mean"]]),
                                        dtype=torch.float32),
                      inv_std=torch.tensor(nd["inv_std"], dtype=torch.float32),
                      gamma=torch.tensor(nd["gamma"], dtype=torch.float32),
                      beta=torch.tensor(nd["beta"], dtype=torch.float32), slope=0.01)
    y, s = rc.conv3d_rows(x, norm, w, None, slope=0.01, out_dtype=torch.float32)
    for i in range(2):
        ni = rc.NormAct(norm.mean[i], norm.inv_std, norm.gamma, norm.beta, 0.01)
        yi, si = rc.conv3d_rows(x[i:i + 1], ni, w, None, slope=0.01,
                                out_dtype=torch.float32)
        torch.testing.assert_close(y[i:i + 1], yi)
        torch.testing.assert_close(s[i:i + 1], si, rtol=1e-5, atol=1e-4)  # summation order
    ident = rc.identity_normact(8)
    y0, _ = rc.conv3d_rows(x, ident, w, None, out_dtype=torch.float32)
    ref = torch.nn.functional.conv3d(
        x.to(torch.bfloat16).float().permute(0, 4, 1, 2, 3),
        w.to(torch.bfloat16).float().permute(4, 3, 0, 1, 2), padding=1)
    torch.testing.assert_close(y0, ref.permute(0, 2, 3, 4, 1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,cout", [(1, 32), (24, 40), (64, 16)])
def test_conv_weight_pack_is_the_mma_fragment_order(cin, cout):
    """Lane 4g + t of the m16n8k16 product holds B[k][n] for k = 2t + e
    (+8 for its second register) and n = g of each n8 tile: the packed
    weights give every (tap, k, n) back from that rule, zero past cin/cout."""
    w = torch.randn(3, 3, 3, cin, cout, generator=torch.Generator().manual_seed(cin))
    cin_k, cout_p = -(-cin // 16) * 16, next(c for c in (16, 32, 64) if c >= cout)
    pk = rc.pack_conv_weights(w, cin_k, cout_p).float().reshape(27, cin_k // 16,
                                                                 cout_p // 16, 32, 8)
    got = torch.empty(27, cin_k, cout_p)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(8):
            q, h, e = j // 4, (j // 2) % 2, j % 2
            for kc in range(cin_k // 16):
                for p in range(cout_p // 16):
                    got[:, kc * 16 + 8 * h + 2 * t + e, p * 16 + 8 * q + g] = pk[:, kc, p, lane, j]
    want = torch.zeros(27, cin_k, cout_p)
    want[:, :cin, :cout] = w.to(torch.bfloat16).float().reshape(27, cin, cout)
    assert torch.equal(got, want)


def test_stats_from_sums_matches_reference():
    rng = np.random.default_rng(8)
    sums = np.abs(rng.normal(size=(2, 5)).astype(np.float32)) * [[1.0], [50.0]]
    mj, ij = jrc.stats_from_sums(jnp.asarray(sums), 7, 1e-5)
    mt, it = rc.stats_from_sums(torch.from_numpy(sums.astype(np.float32)), 7, 1e-5)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-6)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=1e-6)


# ---------------------------------------------------------------------------
# K1 on the wide-channel kernel: its packing, its batched split contract and
# the tap-folded input conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cout", [16, 32, 64])
@pytest.mark.parametrize("cin", [1, 32, 64])
def test_rows_weight_pack_is_the_fragment_order(cin, cout):
    """`pack_rows` at K1's layers: for cin > 1 the wide-channel kernel's
    order (N tile, chunk, tap, k step, column pair, lane), for cin = 1 the
    27 taps folded into K = 32 (k step, column pair of the whole cout,
    lane); lane 4g + t holds B[k][n] for k = 2t + e (+8) and n = g of two n8
    tiles. Zero past cin, cout and the 27 taps; `unpack_rows` inverts it."""
    from boa_tpu_torch.ops import pallas_conv as pc

    gen = torch.Generator().manual_seed(cin + cout)
    w = torch.randn(3, 3, 3, cin, cout, generator=gen)
    b = torch.randn(cout, generator=gen)
    p = rc.pack_rows(w, b)
    ck, nch, bn, cout_p = pc._plan(cin, cout, fold=cin == 1)
    assert cout_p == (32 if cout <= 32 else 64) and bn == (32 if cin == 1 or cout <= 32 else 64)
    wb = w.to(torch.bfloat16).float()
    if cin == 1:
        assert ck == 1 and p.w.numel() == 32 * cout_p
        pk = p.w.float().reshape(2, cout_p // 16, 32, 8)
        got = torch.empty(32, cout_p)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for j in range(8):
                q, h, e = j // 4, (j // 2) % 2, j % 2
                for s in range(2):
                    for pp in range(cout_p // 16):
                        got[s * 16 + 8 * h + 2 * t + e, pp * 16 + 8 * q + g] = pk[s, pp, lane, j]
        want = torch.zeros(32, cout_p)
        want[:27, :cout] = wb.reshape(27, cout)
    else:
        assert ck == 32 and nch == cin // 32
        pk = p.w.float().reshape(cout_p // bn, nch, 27, 2, bn // 16, 32, 8)
        got = torch.empty(27, nch * ck, cout_p)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for j in range(8):
                q, h, e = j // 4, (j // 2) % 2, j % 2
                for nb in range(cout_p // bn):
                    for c in range(nch):
                        for s in range(2):
                            for pp in range(bn // 16):
                                got[:, c * ck + s * 16 + 8 * h + 2 * t + e,
                                    nb * bn + pp * 16 + 8 * q + g] = pk[nb, c, :, s, pp, lane, j]
        want = torch.zeros(27, cin, cout_p)
        want[:, :, :cout] = wb.reshape(27, cin, cout)
    assert torch.equal(got, want)
    assert p.kind == "conv3d_rows" and torch.equal(p.bias[:cout], b) and not p.bias[cout:].any()
    wu, bu = rc.unpack_rows(p)
    assert torch.equal(wu, wb) and torch.equal(bu, b)


def _batch_reference(x, w, b, nds, slope):
    """The reference `conv3d_rows` (interpret mode) per sample of x (N, X,
    Y, Z, cin): (y (N, X, Y, Z, cout), sums (N, 2, cout))."""
    ys, ss = [], []
    for xi, nd in zip(x, nds):
        nj, _ = _norms(nd, slope)
        yj, sj = jrc.conv3d_rows(jnp.asarray(_to_rows(xi)), nj,
                                 jnp.asarray(np.transpose(w, (2, 0, 1, 3, 4))),
                                 jnp.asarray(b), slope=slope, out_dtype=jnp.float32,
                                 interpret=True, bx=8)
        ys.append(_from_rows(np.asarray(yj)))
        ss.append(np.asarray(sj))
    return np.stack(ys), np.stack(ss)


def _batch_inputs(seed, n, cin, cout, shape=(8, 128, 4)):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, *shape, cin)) * 2.0 + 0.3).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = (rng.normal(size=cout) * 0.1).astype(np.float32)
    nds = [_norm_np(rng, cin) for _ in range(n)]
    return x, w, b, nds


def _batch_norm(nds, slope):
    """Per-sample NormAct (N, cin) fields for the port."""
    return rc.NormAct(**{k: torch.tensor(np.stack([nd[k] for nd in nds]), dtype=torch.float32)
                         for k in nds[0]}, slope=slope)


@pytest.mark.parametrize("split", ["one", "two", "chunks", "planes"])
def test_rows_split_partials_at_a_batch_of_two_match_reference(split):
    """K1's split contract on the CPU: the plain split partials of a batch
    of two (N, splits, X, Y, Z, cout), summed by the plain finishing pass
    and placed in the last 32 channels of a 64-wide buffer (voxel stride
    64 > cout, as the kernel's finishing pass stores them), match the
    reference per sample at its bars. cin 40 is a whole chunk and a ragged
    one."""
    from boa_tpu_torch.ops import pallas_conv as pc

    n, cin, cout = 2, 40, 32
    x, w, b, nds = _batch_inputs(40, n, cin, cout)
    nch = pc._plan(cin, cout)[1]
    splits, taps = {"one": (1, 1), "two": (2, 1), "chunks": (nch, 1),
                    "planes": (3 * nch, 3)}[split]
    norm = _batch_norm(nds, 0.01)
    parts = pc.split_partials_plain(torch.from_numpy(x), norm, torch.from_numpy(w),
                                    slope=0.01, splits=splits, taps=taps)
    assert parts.shape == (n, splits, *x.shape[1:4], cout)
    cat = torch.full((n, *x.shape[1:4], 64), 3.0, dtype=torch.float32)
    y, s = pc.finish_plain(parts, torch.from_numpy(b), torch.float32)
    cat[..., 32:] = y   # the kernel's finishing pass stores with voxel stride 64
    assert y.shape == (n, *x.shape[1:4], cout) and s.shape == (n, 2, cout)
    assert bool((cat[..., :32] == 3.0).all())
    yj, sj = _batch_reference(x, w, b, nds, 0.01)
    for i in range(n):
        _check(cat[i, ..., 32:].numpy(), s[i].numpy(), yj[i], sj[i])


def test_rows_wrapper_at_a_batch_of_two_matches_reference():
    """The public `conv3d_rows` on the CPU at N = 2 with per-sample norms
    and a per-channel slope, into a channel slice, against the reference."""
    n, cin, cout = 2, 24, 16
    x, w, b, nds = _batch_inputs(24, n, cin, cout)
    slope = np.concatenate([np.ones(cin // 2), np.full(cin - cin // 2, 0.01)])
    cat = torch.zeros((n, *x.shape[1:4], 48), dtype=torch.float32)
    y, s = rc.conv3d_rows(torch.from_numpy(x), _batch_norm(nds, 1.0), None, None,
                          slope=torch.tensor(slope, dtype=torch.float32),
                          out_dtype=torch.float32,
                          w_packed=rc.pack_rows(torch.from_numpy(w), torch.from_numpy(b)),
                          out=cat[..., 16:32])
    assert y.data_ptr() == cat[..., 16:].data_ptr() and s.shape == (n, 2, cout)
    assert not cat[..., :16].any() and not cat[..., 32:].any()
    ys, ss = [], []
    for xi, nd in zip(x, nds):
        nj, _ = _norms(nd, 1.0)
        yj, sj = jrc.conv3d_rows(jnp.asarray(_to_rows(xi)), nj,
                                 jnp.asarray(np.transpose(w, (2, 0, 1, 3, 4))),
                                 jnp.asarray(b), slope=jnp.asarray(slope, jnp.float32),
                                 out_dtype=jnp.float32, interpret=True, bx=8)
        ys.append(_from_rows(np.asarray(yj)))
        ss.append(np.asarray(sj))
    for i in range(n):
        _check(cat[i, ..., 16:32].numpy(), s[i].numpy(), ys[i], ss[i])


@pytest.mark.parametrize("cout", [16, 32])
def test_folded_input_conv_matches_reference(cout):
    """cin = 1: the tap-folded packing, unpacked by the plain version, gives
    the reference's conv at its bars, at N = 2 with per-sample norms."""
    n = 2
    x, w, b, nds = _batch_inputs(cout, n, 1, cout)
    p = rc.pack_rows(torch.from_numpy(w), torch.from_numpy(b))
    assert p.w.numel() == 32 * 32   # 27 taps padded to 32, one 32-wide N tile
    y, s = rc.conv3d_rows_plain(torch.from_numpy(x), _batch_norm(nds, 0.01), None, None,
                                slope=0.01, out_dtype=torch.float32, w_packed=p)
    yj, sj = _batch_reference(x, w, b, nds, 0.01)
    assert y.shape == (n, *x.shape[1:4], cout) and s.shape == (n, 2, cout)
    for i in range(n):
        _check(y[i].numpy(), s[i].numpy(), yj[i], sj[i])
