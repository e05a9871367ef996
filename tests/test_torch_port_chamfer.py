"""The port's Chamfer op held against the JAX package on the CPU.

On the CPU every port wrapper takes its plain version (``ops/reference.py``),
which the CUDA kernels are held to on the card (``tests/test_torch_port_gpu.py``).
Inputs are numpy arrays from a seed. Tolerances:

- the group regime (N*M <= 4096, JAX's dense direct form, as in the recon
  loss): distances and indices exactly equal;
- the Pallas kernels in interpret mode at ragged and multi-tile sizes:
  indices exactly equal, distances within 2e-7 relative (XLA's CPU code for
  the kernel body rounds the three-term sum differently from separate
  roundings: one f32 ulp apart measured);
- 4096 < N*M <= 2^21 (JAX's dense expanded form, clamped at 0): distances
  within 1e-5, indices only where the nearest point is separated from the
  second nearest by more than 1e-4;
- gradients against ``jax.grad``: within 1e-5 of the largest gradient (the
  scatter sums run in another order);
- ``gradcheck`` of the plain path in f64 at its default tolerances.
"""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from act_tpu import ops as jops
from act_tpu.ops import chamfer as jchamfer

from act_tpu_torch import ops
from act_tpu_torch.ops import _backend
from act_tpu_torch.kernel_sweep import CHAMFER_SHAPES
from act_tpu_torch.ops import chamfer as chamfer_mod
from act_tpu_torch.ops.reference import pair_distance

from tests.test_torch_port_ops import one_torch_thread  # noqa: F401  (autouse)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def interpret():
    """Pallas kernels through the interpreter, as tests/test_ops.py runs them."""
    old = os.environ.get("ACT_TPU_PALLAS")
    os.environ["ACT_TPU_PALLAS"] = "interpret"
    yield
    if old is None:
        os.environ.pop("ACT_TPU_PALLAS", None)
    else:
        os.environ["ACT_TPU_PALLAS"] = old


def clouds(rng, B, N, M):
    return (rng.normal(size=(B, N, 3)).astype(np.float32),
            rng.normal(size=(B, M, 3)).astype(np.float32))


def separated(rng, B, N, M, noise=1e-3):
    """y random, x near a random subset of y: both directions' nearest points
    are clear of the second nearest on most queries."""
    y = rng.normal(size=(B, M, 3)).astype(np.float32)
    pick = np.stack([rng.choice(M, N, replace=N > M) for _ in range(B)])
    x = np.take_along_axis(y, pick[..., None], 1) + noise * rng.normal(size=(B, N, 3))
    return x.astype(np.float32), y


def margin(q, p):
    """Second-nearest minus nearest squared distance of each query, in f64."""
    d = ((q[:, :, None, :].astype(np.float64) - p[:, None, :, :]) ** 2).sum(-1)
    s = np.sort(d, axis=-1)
    return s[..., 1] - s[..., 0]


@pytest.mark.parametrize("B,N,M", [(64, 8, 32), (64, 32, 32), (5, 1, 7), (3, 40, 1)])
def test_group_regime_matches_jax_exactly(rng, B, N, M):
    """The recon loss's shapes: JAX's dense direct form; the port's plain
    version and its public op give the same bits and the same indices."""
    x, y = clouds(rng, B, N, M)
    jd1, ji1, jd2, ji2 = jchamfer._nearest_pair(jnp.asarray(x), jnp.asarray(y))
    d1, d2, i1, i2 = ops.chamfer_ref(t(x), t(y))
    assert i1.dtype == i2.dtype == torch.int32
    for got, want in ((d1, jd1), (d2, jd2), (i1, ji1), (i2, ji2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pd1, pd2 = ops.chamfer_distances(t(x), t(y))
    jp1, jp2 = jops.chamfer_distances(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(pd1.numpy(), np.asarray(jp1))
    np.testing.assert_array_equal(pd2.numpy(), np.asarray(jp2))


def test_ties_take_the_first_index():
    """Duplicated points: both directions pick the first of equal minima,
    as the Pallas kernel (chamfer.py:75-79) and the dense argmin do."""
    y = np.array([[[0, 0, 0], [1, 0, 0], [0, 0, 0], [1, 0, 0]]], np.float32)
    x = np.array([[[0.5, 0, 0], [1, 0, 0], [0, 0, 0]]], np.float32)
    _, _, i1, i2 = ops.chamfer_ref(t(x), t(y))
    jd1, ji1, jd2, ji2 = jchamfer._nearest_pair(jnp.asarray(x), jnp.asarray(y))
    assert i1.tolist() == [[0, 1, 0]] and i2.tolist() == [[2, 1, 2, 1]]
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ji2))


@pytest.mark.pallas
@pytest.mark.parametrize("B,N,M", [(2, 150, 300), (1, 513, 2100)])
def test_matches_pallas_kernels_in_interpret_mode(rng, interpret, B, N, M):
    x, y = clouds(rng, B, N, M)
    jd1, ji1, jd2, ji2 = jchamfer._nn_pair_pallas(jnp.asarray(x), jnp.asarray(y))
    jm1, jm2 = jchamfer._nn_pair_min_pallas(jnp.asarray(x), jnp.asarray(y))
    d1, d2, i1, i2 = ops.chamfer_ref(t(x), t(y))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ji2))
    m1, m2 = ops.chamfer_min_ref(t(x), t(y))
    assert torch.equal(m1, d1) and torch.equal(m2, d2)
    for got, want in ((d1, jd1), (d2, jd2), (m1, jm1), (m2, jm2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7, atol=0)


def test_expanded_form_regime_within_rounding(rng):
    """4096 < N*M <= 2^21: JAX takes the expanded form x^2 + y^2 - 2xy."""
    x, y = separated(rng, 2, 300, 700)
    jd1, ji1, jd2, ji2 = jchamfer._nearest_pair(jnp.asarray(x), jnp.asarray(y))
    d1, d2, i1, i2 = ops.chamfer_ref(t(x), t(y))
    np.testing.assert_allclose(d1.numpy(), np.asarray(jd1), rtol=0, atol=1e-5)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=0, atol=1e-5)
    for i, ji, q, p in ((i1, ji1, x, y), (i2, ji2, y, x)):
        clear = margin(q, p) > 1e-4
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(i.numpy()[clear], np.asarray(ji)[clear])


@pytest.mark.parametrize("loss", ["chamfer_distance_l1", "chamfer_distance_l2"])
@pytest.mark.parametrize("B,N,M", [(64, 8, 32), (1, 1100, 2000)])
def test_gradients_match_jax(rng, monkeypatch, loss, B, N, M):
    """Both of JAX's backward regimes: one-hot contractions (max(N, M) <=
    256) and, above, the Pallas gather kernel plus a scatter-add. The large
    case has N*M > 2^21, so JAX's forward is the Pallas pair kernel (in
    interpret mode), whose direct-form distances the port shares; the
    expanded form of the dense path would move L1's 1/sqrt(d) weights of
    close pairs by its cancellation error."""
    if N * M > 1 << 21:
        monkeypatch.setenv("ACT_TPU_PALLAS", "interpret")
    x, y = separated(rng, B, N, M, noise=0.05)
    want = jax.grad(getattr(jops, loss), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = t(x).requires_grad_(), t(y).requires_grad_()
    value = getattr(ops, loss)(tx, ty)
    value.backward()
    np.testing.assert_allclose(value.item(), float(getattr(jops, loss)(jnp.asarray(x),
                                                                       jnp.asarray(y))),
                               rtol=1e-6)
    for got, w in ((tx.grad, want[0]), (ty.grad, want[1])):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("case", ["mixed magnitudes", "many onto one", "signed zeros"])
def test_bwd_ref_sums_in_ascending_source_order(rng, case):
    """``chamfer_bwd_ref`` on the CPU equals an explicit loop that sums each
    target's sources in ascending source index from +0, bit for bit, on
    values whose f32 sum depends on the order (magnitudes 1e-8 to 1e8, up to
    200 sources on one target, gradients of -0). The card's group body sums
    in that order, so its gradients equal the plain version bit for bit."""
    B, N, M = 3, 32, 200 if case == "many onto one" else 32
    x, y = (t(a) for a in clouds(rng, B, N, M))
    i1 = t(rng.integers(0, M, size=(B, N)).astype(np.int32))
    i2 = t(rng.integers(0, 2 if case == "many onto one" else N, size=(B, M)).astype(np.int32))
    g1, g2 = (t(rng.normal(size=(B, n)).astype(np.float32)
                * 10.0 ** rng.integers(-8, 9, size=(B, n)).astype(np.float32)) for n in (N, M))
    if case == "signed zeros":
        g1[:, ::2], g2[:, 1::2] = -0.0, -0.0
    dx, dy = ops.chamfer_bwd_ref(x, y, i1, i2, g1, g2)
    v1 = 2.0 * (x - ops.gather_points(y, i1)) * g1[:, :, None]
    v2 = 2.0 * (y - ops.gather_points(x, i2)) * g2[:, :, None]
    for d, v, w, idx, n in ((dx, v1, v2, i2, N), (dy, v2, v1, i1, M)):
        want = v.clone()
        for b in range(B):
            sums = [np.zeros(3, np.float32) for _ in range(n)]
            for src, j in enumerate(idx[b].tolist()):  # ascending source index
                sums[j] = (sums[j] + w[b, src].numpy()).astype(np.float32)
            want[b] = v[b] - torch.from_numpy(np.stack(sums))
        assert torch.equal(d, want) and torch.equal(torch.signbit(d), torch.signbit(want))
    if case == "mixed magnitudes":  # the order matters for these values
        sx = torch.zeros(B * N, 3).index_add_(0, (torch.arange(B)[:, None] * N + i2.long())
                                              .reshape(-1).flip(0), v2.reshape(-1, 3).flip(0))
        assert not torch.equal(v1 - sx.reshape(B, N, 3), dx)


@pytest.mark.parametrize("name", [n for n in chamfer_mod.BWD_CASES if n != "out of range"])
def test_bwd_hard_cases_hold_the_plain_version(name):
    """``check_bwd_case`` (which the card's backward is held to) passes the
    plain version itself; on the order-sensitive case it fails a backward
    that sums each target's sources in descending order."""
    assert chamfer_mod.check_bwd_case(name, ops.chamfer_bwd_ref)
    if name != "signed zeros, mixed magnitudes":
        return

    def descending(x, y, i1, i2, g1, g2):
        (B, N, _), M = x.shape, y.shape[1]
        v1 = 2.0 * (x - ops.gather_points(y, i1)) * g1[:, :, None]
        v2 = 2.0 * (y - ops.gather_points(x, i2)) * g2[:, :, None]
        rx = (torch.arange(B)[:, None] * N + i2.long()).reshape(-1).flip(0)
        ry = (torch.arange(B)[:, None] * M + i1.long()).reshape(-1).flip(0)
        sx = torch.zeros(B * N, 3).index_add_(0, rx, v2.reshape(-1, 3).flip(0))
        sy = torch.zeros(B * M, 3).index_add_(0, ry, v1.reshape(-1, 3).flip(0))
        return v1 - sx.reshape(B, N, 3), v2 - sy.reshape(B, M, 3)
    assert not chamfer_mod.check_bwd_case(name, descending)


def test_split_loss_and_l2_agree(rng):
    x, y = clouds(rng, 4, 10, 12)
    a, b = ops.chamfer_distance_l2_split(t(x), t(y))
    ja, jb = jops.chamfer_distance_l2_split(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose([float(a), float(b)], [float(ja), float(jb)], rtol=1e-6)
    assert float(ops.chamfer_distance_l2(t(x), t(y))) == float(a + b)


def test_gradcheck_plain_path_f64(rng):
    x, y = (torch.from_numpy(a.astype(np.float64)) for a in clouds(rng, 2, 5, 7))
    x.requires_grad_()
    y.requires_grad_()
    assert torch.autograd.gradcheck(ops.chamfer_distances, (x, y))
    assert torch.autograd.gradcheck(ops.chamfer_distance_l1, (x, y))


def test_no_grad_call_saves_no_indices(rng, monkeypatch):
    """Without a gradient only the distance-only forward runs; under grad the
    indexed forward runs and its indices are saved for the backward."""
    calls = []
    for name in ("chamfer_ref", "chamfer_min_ref", "chamfer_bwd_ref"):
        fn = getattr(chamfer_mod, name)
        monkeypatch.setattr(chamfer_mod, name,
                            lambda *a, fn=fn, name=name: calls.append(name) or fn(*a))
    x, y = (t(a).requires_grad_() for a in clouds(rng, 3, 6, 9))
    with torch.no_grad():
        d1, _ = ops.chamfer_distances(x, y)
    assert calls == ["chamfer_min_ref"] and d1.grad_fn is None
    d1, _ = ops.chamfer_distances(x.detach(), y.detach())
    assert calls == ["chamfer_min_ref"] * 2 and d1.grad_fn is None
    d1, d2 = ops.chamfer_distances(x, y)
    assert calls[-1] == "chamfer_ref"
    saved = d1.grad_fn.saved_tensors
    assert [s.dtype for s in saved[2:]] == [torch.int32, torch.int32]
    (d1.sum() + d2.sum()).backward()
    assert calls[-1] == "chamfer_bwd_ref"


def test_cpu_path_launches_no_kernel(rng):
    _backend.reset_launches()
    x, y = (t(a).requires_grad_() for a in clouds(rng, 2, 8, 8))
    ops.chamfer_distance_l1(x, y).backward()
    assert all(v == 0 for v in _backend.LAUNCHES.values())


def test_wrappers_validate_arguments():
    x = torch.zeros(2, 5, 3)
    with pytest.raises(ValueError, match="clouds"):
        ops.chamfer_distances(x[..., :2], x)
    with pytest.raises(ValueError, match="batch size"):
        ops.chamfer_distances(x, torch.zeros(3, 5, 3))
    with pytest.raises(ValueError, match="a point each"):
        ops.chamfer_distances(x, torch.zeros(2, 0, 3))
    meta = torch.empty(2, 5, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.chamfer_distances(meta, meta)
    i, g = torch.zeros(2, 5, dtype=torch.int32), torch.zeros(2, 5)
    with pytest.raises(ValueError, match="chamfer_bwd"):
        chamfer_mod.chamfer_bwd(x, x, i, i, g, g[:, :4])


# -- the forward's tiling (ops/chamfer.py launch_geometry) and merge keys ----

# one validation cloud, the whole-cloud op, the recon loss's two calls, a
# ragged pair, single-point clouds and N or M of 1
TILING_SHAPES = [(1, 2048, 1024), (32, 2048, 2048), (4096, 8, 32), (4096, 32, 32),
                 (3, 777, 1001), (5, 1, 40), (2, 300, 1), (1, 1, 1), (3, 1, 2048),
                 (2, 2048, 1), (7, 33, 5), (64, 32, 1024)]


def covered_intervals(B, N, M, geo):
    """For each lane and each of its points of x: (cloud, point of x, first
    and end of its warp's share of points of y, the lane's offset across y),
    from the index arithmetic of ``nn_kernel`` in ``csrc/chamfer.cu`` (a lane
    walks its share's points lane, lane + wt, ...); also each lane's warp
    and share length, which must be the same across a warp (its shuffles)."""
    tq, tt, r, threads, pack = geo
    w, wq = chamfer_mod.lanes(tq, r, threads, pack)
    per_warp, warps = 32 // w, threads // 32
    wpc = warps if pack == 1 else 1
    qtiles, ttiles = -(-N // tq), -(-M // tt)
    tiles = B * qtiles * ttiles
    blocks = -(-tiles // pack)
    blk, tid = np.divmod(np.arange(blocks * threads), threads)
    warp, lane = tid // 32, tid % 32
    seg, sl = lane // w, lane % w
    ql, tl = sl % wq, sl // wq
    slot = (warp // wpc) * per_warp + seg
    u = blk * pack + slot
    on = u < tiles
    u = np.where(on, u, 0)
    cloud, rest = np.divmod(u, qtiles * ttiles)
    q0, t0 = rest // ttiles * tq, rest % ttiles * tt
    chunk = -(-tt // wpc)
    lo = (warp % wpc) * chunk
    cnt = np.maximum(0, np.minimum(chunk, np.minimum(tt, M - t0) - lo))
    q = q0[:, None] + ql[:, None] * r + np.arange(r)
    keep = on[:, None] & (q < N) & (tl < cnt)[:, None]
    rows = [np.broadcast_to(a[:, None], q.shape)[keep]
            for a in (cloud, t0 + lo, t0 + lo + cnt, tl)]
    return (rows[0], q[keep], *rows[1:]), (blk * warps + warp, cnt)


def assert_covers_every_pair_once(B, N, M, geo):
    """Every (point of x, point of y) pair of every cloud lies in exactly one
    lane's walk, and the launch is one the C launcher accepts."""
    tq, tt, r, threads, pack = geo
    w, wq = chamfer_mod.lanes(tq, r, threads, pack)
    assert r in (1, 2, 4, 8, 16) and wq * r == tq and wq & (wq - 1) == 0 and w % wq == 0
    assert threads % 32 == 0 and 32 <= threads <= 256 and tt >= 1
    assert pack == 1 or (pack % (threads // 32) == 0 and 32 % (pack // (threads // 32)) == 0)
    assert w == 32 or (N <= tq and M <= tt)  # tiles share a warp only whole
    (cloud, q, first, end, tl), (warp_id, cnt) = covered_intervals(B, N, M, geo)
    wt = w // wq
    order = np.lexsort((tl, first, q, cloud))
    cloud, q, first, end, tl = cloud[order], q[order], first[order], end[order], tl[order]
    share = np.r_[True, (cloud[1:] != cloud[:-1]) | (q[1:] != q[:-1])
                  | (first[1:] != first[:-1])]
    # the wt lanes across y of each share: each offset once, as many as the share holds
    starts = np.flatnonzero(share)
    sizes = np.diff(np.r_[starts, len(tl)])
    assert np.all(sizes == np.minimum(wt, end[starts] - first[starts]))
    assert np.all(tl == np.arange(len(tl)) - np.repeat(starts, sizes))
    cloud, q, first, end = cloud[starts], q[starts], first[starts], end[starts]
    key = cloud.astype(np.int64) * N + q
    new = np.r_[True, key[1:] != key[:-1]]
    assert np.array_equal(np.unique(key), np.arange(B * N))  # every point of x
    assert np.all(first[new] == 0)                            # from the first point of y
    assert np.all(end[np.r_[new[1:], True]] == M)             # to the last
    assert np.all(first[~new] == end[np.flatnonzero(~new) - 1])  # no gap, no overlap
    by_warp = np.lexsort((cnt, warp_id))
    w_sorted, c_sorted = warp_id[by_warp], cnt[by_warp]
    same = w_sorted[1:] == w_sorted[:-1]
    assert np.all(c_sorted[1:][same] == c_sorted[:-1][same])  # uniform within a warp
    assert chamfer_mod.shared_bytes(*geo) <= 48 * 1024


@pytest.mark.parametrize("B,N,M", TILING_SHAPES)
def test_launch_geometry_covers_every_pair_once(B, N, M):
    assert_covers_every_pair_once(B, N, M, chamfer_mod.launch_geometry(B, N, M, 132))


@pytest.mark.parametrize("shape", list(CHAMFER_SHAPES))
def test_swept_tilings_cover_every_pair_once(shape):
    """Each tiling that ``kernel_sweep`` times, and the pick it is held
    against, at its shape."""
    tilings = CHAMFER_SHAPES[shape]
    assert chamfer_mod.launch_geometry(*shape, 132) in tilings and len(tilings) <= 6
    for geo in tilings:
        assert_covers_every_pair_once(*shape, geo)


def test_launch_geometry_fills_the_card_at_one_validation_cloud():
    """At least two blocks an SM for one validation cloud, (1, 2048)x(1, 1024)."""
    tq, tt, r, threads, pack = chamfer_mod.launch_geometry(1, 2048, 1024, 132)
    blocks = -(-(-(-2048 // tq) * -(-1024 // tt)) // pack)
    assert blocks >= 2 * 132


@pytest.mark.parametrize("N", [1, 2, 8, 31, 32, 33, 300, 2048, 8192])
@pytest.mark.parametrize("M", [1, 7, 32, 64, 512, 513, 2048, 8192])
def test_launch_geometry_shared_memory_within_48kb(N, M):
    """The default 48 KB a block, with chamfer_nn's 8-byte keys, at any shape."""
    for B in (1, 3, 64, 4096):
        geo = chamfer_mod.launch_geometry(B, N, M, 132)
        assert chamfer_mod.shared_bytes(*geo) <= 48 * 1024, (B, N, M, geo)


def merge_keys(d: np.ndarray, axis: int) -> np.ndarray:
    """(f32 bits << 32) | index along ``axis``, as chamfer_nn merges tiles."""
    idx = np.arange(d.shape[axis], dtype=np.uint64)
    idx = idx[None, :] if axis == 1 else idx[:, None]
    bits = np.ascontiguousarray(d).view(np.uint32).astype(np.uint64)
    return (bits << np.uint64(32)) | idx


@pytest.mark.parametrize("case", ["random", "ties", "all equal", "inf", "some inf"])
def test_merge_key_minimum_is_min_and_first_index(rng, case):
    """The smallest (distance bits, index) key of a row or column gives the
    plain version's minimum and first index, with ties and inf distances;
    taking it tile by tile (any order) gives the same key."""
    x, y = clouds(rng, 1, 40, 50)
    if case == "ties":
        y = np.concatenate([y[:, :10]] * 5, 1)
        x = np.concatenate([x[:, :8]] * 5, 1)
    elif case == "all equal":
        x, y = np.ones_like(x), np.ones_like(y)
    elif case == "inf":
        x, y = 2e19 + 1e18 * x, -2e19 + 1e18 * y
    elif case == "some inf":
        x = np.concatenate([2e19 + 1e18 * x[:, :20], x[:, 20:]], 1)
    x, y = x.astype(np.float32), y.astype(np.float32)
    d = pair_distance(t(x), t(y))[0].numpy()
    d1, d2, i1, i2 = (a[0].numpy() for a in ops.chamfer_ref(t(x), t(y)))
    assert case not in ("inf", "some inf") or np.isinf(d1).any()
    for axis, dist, index in ((1, d1, i1), (0, d2, i2)):
        keys = merge_keys(d, axis)
        best = keys.min(axis=axis)
        np.testing.assert_array_equal((best >> np.uint64(32)).astype(np.uint32).view(np.float32),
                                      dist)
        np.testing.assert_array_equal((best & np.uint64(0xFFFFFFFF)).astype(np.int32), index)
        parts = np.array_split(keys, 7, axis=axis)
        tiled = np.stack([p.min(axis=axis) for p in parts[::-1]]).min(axis=0)
        np.testing.assert_array_equal(tiled, best)
