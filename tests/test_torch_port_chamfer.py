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
from act_tpu_torch.ops import chamfer as chamfer_mod


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
