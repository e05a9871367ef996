"""The PyTorch port's point ops held against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages as numpy
arrays. The port's CPU path is its plain PyTorch versions; the JAX side runs
its XLA references and, with ``ACT_TPU_PALLAS=interpret``, its Pallas kernels
through the interpreter. Indices must be exact on continuous random clouds.
"""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from act_tpu import ops as jops
from act_tpu.ops import fps as jfps
from act_tpu.ops.gather import gather_points_pallas
from act_tpu.ops.topk import k_smallest_pallas

from act_tpu_torch import ops
from act_tpu_torch.ops import _backend


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


def cloud(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


def test_square_distance_matches_jax(rng):
    src, dst = cloud(rng, 2, 37, 3), cloud(rng, 2, 300, 3)
    got = ops.square_distance(t(src), t(dst)).numpy()
    want = np.asarray(jops.square_distance(jnp.asarray(src), jnp.asarray(dst)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,N,S", [(3, 200, 16), (2, 1024, 64), (1, 777, 130)])
def test_fps_matches_jax_ref(rng, B, N, S):
    pts = cloud(rng, B, N, 3)
    want = np.asarray(jops.furthest_point_sample_ref(jnp.asarray(pts), S))
    np.testing.assert_array_equal(ops.furthest_point_sample_ref(t(pts), S).numpy(), want)
    got = ops.furthest_point_sample(t(pts), S)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fps_per_cloud_start_matches_jax(rng):
    pts = cloud(rng, 3, 200, 3)
    start = rng.integers(0, 200, size=(3,)).astype(np.int32)
    want = np.asarray(jops.furthest_point_sample_ref(jnp.asarray(pts), 16,
                                                     jnp.asarray(start)))
    got = ops.furthest_point_sample(t(pts), 16, start_idx=t(start)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], start)
    scalar = ops.furthest_point_sample(t(pts), 16, start_idx=5).numpy()
    np.testing.assert_array_equal(scalar[:, 0], np.full(3, 5))


@pytest.mark.pallas
def test_fps_matches_pallas_interpret(rng, interpret):
    pts = cloud(rng, 3, 300, 3)
    start = rng.integers(0, 300, size=(3,)).astype(np.int32)
    for s in (None, start):
        want = np.asarray(jfps._fps_pallas_batched(
            jnp.asarray(pts), 40, None if s is None else jnp.asarray(s)))
        got = ops.furthest_point_sample(t(pts), 40,
                                        None if s is None else t(s)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,k", [((2, 64, 1024), 32), ((1, 9, 777), 3),
                                     ((3, 37, 130), 4)])
def test_k_smallest_matches_jax_top_k(rng, shape, k):
    d = cloud(rng, *shape)
    vals, idx = ops.k_smallest(t(d), k)
    neg, want_idx = jax.lax.top_k(-jnp.asarray(d), k)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))


@pytest.mark.pallas
def test_k_smallest_matches_pallas_interpret(rng, interpret):
    d = cloud(rng, 2, 24, 300)
    v_p, i_p = k_smallest_pallas(jnp.asarray(d), 8)
    vals, idx = ops.k_smallest(t(d), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_p))
    np.testing.assert_allclose(vals.numpy(), np.asarray(v_p), atol=1e-6)


def test_k_smallest_ties_go_to_smaller_index(rng):
    """Rows of small integers tie everywhere; the order must be the JAX
    top_k's (ascending, smaller index first), which a stable sort gives."""
    d = rng.integers(0, 4, size=(5, 200)).astype(np.float32)
    _, idx = ops.k_smallest(t(d), 20)
    _, want = jax.lax.top_k(-jnp.asarray(d), 20)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    _, zeros_idx = ops.k_smallest(torch.zeros(1, 256), 5)
    np.testing.assert_array_equal(zeros_idx.numpy()[0], np.arange(5))


def test_k_smallest_ranks_nan_last_in_index_order():
    """The order the CUDA kernel is held to on the card: -0 ties +0, NaNs
    come after +inf in index order, as a stable ascending sort gives."""
    nan, inf = float("nan"), float("inf")
    d = torch.tensor([[3.0, nan, -0.0, 1.0, nan, 0.0, -inf, inf]])
    vals, idx = ops.k_smallest(d, 8)
    np.testing.assert_array_equal(idx.numpy()[0], [6, 2, 5, 3, 0, 7, 1, 4])
    np.testing.assert_array_equal(vals.numpy()[0], [-inf, 0, 0, 1, 3, inf, nan, nan])


def test_knn_matches_jax(rng):
    ref, query = cloud(rng, 2, 500, 3), cloud(rng, 2, 40, 3)
    d_w, i_w = jops.knn_ref(jnp.asarray(ref), jnp.asarray(query), 12)
    for fn in (ops.knn, ops.knn_ref):
        d, i = fn(t(ref), t(query), 12)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_w))
        np.testing.assert_allclose(d.numpy(), np.asarray(d_w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C", [3, 6])
def test_gather_matches_jax(rng, C):
    pts = cloud(rng, 2, 300, C)
    idx = rng.integers(0, 300, size=(2, 40, 7)).astype(np.int32)
    want = np.asarray(jops.gather_points(jnp.asarray(pts), jnp.asarray(idx)))
    got = ops.gather_coords(t(pts), t(idx)).numpy()
    assert got.shape == (2, 40, 7, C)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ops.gather_points(t(pts), t(idx)).numpy(), want)


@pytest.mark.pallas
def test_gather_matches_pallas_interpret(rng, interpret):
    pts = cloud(rng, 2, 300, 3)
    idx = rng.integers(0, 300, size=(2, 500)).astype(np.int32)
    want = np.asarray(gather_points_pallas(jnp.asarray(pts), jnp.asarray(idx)))
    np.testing.assert_array_equal(ops.gather_coords(t(pts), t(idx)).numpy(), want)


def test_group_points_matches_jax(rng):
    xyz = cloud(rng, 2, 512, 3)
    nbr_w, ctr_w = jops.group_points(jnp.asarray(xyz), 16, 8)
    for fn in (ops.group_points, ops.group_points_ref):
        nbr, ctr = fn(t(xyz), 16, 8)
        np.testing.assert_array_equal(ctr.numpy(), np.asarray(ctr_w))
        np.testing.assert_allclose(nbr.numpy(), np.asarray(nbr_w), atol=1e-6)


@pytest.mark.pallas
def test_group_points_matches_pallas_interpret(rng, interpret):
    # shapes used by no other group_points call in this process: the JAX
    # grouping is jitted, and a cached trace would keep the XLA path
    xyz = cloud(rng, 2, 333, 3)
    nbr_w, ctr_w = jops.group_points(jnp.asarray(xyz), 13, 7)
    nbr, ctr = ops.group_points(t(xyz), 13, 7)
    np.testing.assert_array_equal(ctr.numpy(), np.asarray(ctr_w))
    np.testing.assert_allclose(nbr.numpy(), np.asarray(nbr_w), atol=1e-6)


def test_cpu_path_launches_no_kernel(rng):
    _backend.reset_launches()
    ops.group_points(t(cloud(rng, 1, 128, 3)), 8, 4)
    assert all(v == 0 for v in _backend.LAUNCHES.values())


def test_wrappers_reject_other_devices():
    """No hidden fallback: a tensor that is neither on the CPU nor on a card
    is refused, not silently computed elsewhere."""
    pts = torch.empty(2, 64, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.furthest_point_sample(pts, 8)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.k_smallest(torch.empty(4, 64, device="meta"), 3)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.gather_coords(pts, torch.empty(2, 5, dtype=torch.int32, device="meta"))


def test_wrappers_validate_arguments(rng):
    pts = t(cloud(rng, 2, 64, 3))
    with pytest.raises(ValueError):
        ops.furthest_point_sample(pts, 65)
    with pytest.raises(ValueError):
        ops.furthest_point_sample(pts[..., :2], 8)
    with pytest.raises(ValueError):
        ops.furthest_point_sample(pts, 8, start_idx=64)
    for bad in ([0, 64], [-1, 3], [[0], [1]], [0, 1, 2], [0.0, 1.0]):
        with pytest.raises(ValueError, match="start_idx"):
            ops.furthest_point_sample(pts, 8, start_idx=torch.tensor(bad))
    with pytest.raises(ValueError):
        ops.k_smallest(pts[..., 0], 65)
    with pytest.raises(ValueError):
        ops.gather_coords(t(cloud(rng, 2, 64, 9)), torch.zeros(2, 4, dtype=torch.int32))


def test_resolve_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        _backend.resolve_device("cuda")
    assert _backend.resolve_device("cpu").type == "cpu"


def test_kernel_build_names_every_source():
    """Every CUDA source has launch signatures and is built for sm_90a."""
    sources = sorted(p.stem for p in _backend.CSRC.glob("*.cu"))
    assert sources == sorted({src for src, _, _ in _backend.KERNELS.values()})
    assert sorted(_backend.LAUNCHES) == sorted(_backend.KERNELS)
    assert "arch=compute_90a,code=sm_90a" in _backend.NVCC_FLAGS
    assert _backend._target("k_smallest").parent == _backend.BUILD_DIR


def test_fps_launch_geometry():
    """The FPS launch splits a cloud over a cluster while the B*C blocks fit
    the card's SMs one a SM and each keeps MIN_SLICE points, and falls back to
    a smaller cluster when the card cannot run all B clusters at once."""
    from act_tpu_torch.ops.fps import MIN_SLICE, launch_geometry

    def roomy(N, c, threads, ppt):
        return 1000

    for B in (1, 2, 7, 32, 33, 64, 128, 200, 256):
        for N in (1, 20, 777, 1024, 4096, 8192, 16384):
            c, threads, ppt = launch_geometry(B, N, 132, roomy)
            slice_ = -(-N // c)
            assert c in (1, 2, 4, 8) and ppt in (1, 2, 4, 8, 16)
            assert threads % 32 == 0 and 32 <= threads <= 1024
            assert threads * ppt >= slice_
            assert c == 1 or (B * c <= 132 and slice_ >= MIN_SLICE)
            bigger = {1: 2, 2: 4, 4: 8}.get(c)
            if bigger and N >= bigger * MIN_SLICE:  # the next size up did not fit
                assert B * bigger > 132
    assert launch_geometry(1, 8192, 132, roomy)[0] == 8
    assert launch_geometry(32, 8192, 132, roomy)[0] == 4
    assert launch_geometry(64, 8192, 132, roomy)[0] == 2
    assert launch_geometry(128, 8192, 132, roomy)[0] == 1
    assert launch_geometry(32, 8192, 132, roomy) == (4, 256, 8)
    assert launch_geometry(1, 8192, 132, roomy) == (8, 128, 8)
    assert launch_geometry(128, 1024, 132, roomy) == (1, 128, 8)
    assert launch_geometry(32, 8192, 132, lambda N, c, t, p: 0 if c == 4 else 1000)[0] == 2
    assert launch_geometry(32, 8192, 132, lambda N, c, t, p: 31)[0] == 1
