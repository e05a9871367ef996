"""The port's CUDA kernels against their plain versions on the card.

Every test here needs a CUDA card; without one the ``cuda`` fixture skips it.
The file imports neither JAX nor ``act_tpu``, so it runs where only PyTorch is
installed:

  python -m pytest tests/test_torch_port_gpu.py -m gpu --noconftest -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

from act_tpu_torch import ops
from act_tpu_torch.engine.serve import build_infer_fn, load_model
from act_tpu_torch.ops import _backend
from act_tpu_torch.ops.fps import tie_swaps
from act_tpu_torch.utils.config import ConfigDict

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return _backend.resolve_device("cuda")


def cloud(seed, *shape, device):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(device)


@pytest.mark.parametrize("B,N,S", [(2, 20, 7), (3, 777, 100), (4, 1024, 64),
                                   (2, 8192, 1024), (1, 16384, 300)])
def test_fps_kernel_matches_plain(cuda, B, N, S):
    pts = cloud(0, B, N, 3, device=cuda)
    got = ops.furthest_point_sample(pts, S)
    torch.cuda.synchronize()
    assert tie_swaps(got, ops.furthest_point_sample_ref(pts, S)) >= 0
    start = torch.randint(0, N, (B,), generator=torch.Generator().manual_seed(1))
    got = ops.furthest_point_sample(pts, S, start_idx=start.to(cuda))
    want = ops.furthest_point_sample_ref(pts, S, start.to(cuda))
    assert tie_swaps(got, want) >= 0
    assert torch.equal(got[:, 0].cpu(), start.int())


@pytest.mark.parametrize("rows,N,k", [(2048, 1024, 32), (7, 777, 3),
                                      (5, 20000, 16), (3, 64, 64)])
def test_k_smallest_kernel_matches_plain(cuda, rows, N, k):
    d = cloud(2, rows, N, device=cuda).abs()
    vals, idx = ops.k_smallest(d, k)
    want_v, want_i = ops.k_smallest_ref(d, k)
    assert torch.equal(idx, want_i)
    assert torch.equal(vals, want_v)


def test_k_smallest_kernel_ties(cuda):
    g = torch.Generator().manual_seed(3)
    d = torch.randint(0, 4, (64, 300), generator=g).float().to(cuda)
    _, idx = ops.k_smallest(d, 40)
    assert torch.equal(idx, ops.k_smallest_ref(d, 40)[1])


def test_k_smallest_kernel_nan_and_signed_zero(cuda):
    """NaNs rank after +inf in index order and -0 ties +0, as in the plain
    version's stable sort, also where a row holds fewer than k non-NaNs."""
    g = torch.Generator().manual_seed(9)
    d = torch.randint(-2, 3, (40, 300), generator=g).float()
    d[d == 0] = torch.where(torch.rand(int((d == 0).sum()), generator=g) < 0.5, -0.0, 0.0)
    d[torch.rand(d.shape, generator=g) < 0.3] = float("nan")
    d[:5, 10:] = float("nan")  # 10 non-NaNs at most, k = 40
    d[5, :] = float("inf")
    d = d.to(cuda)
    vals, idx = ops.k_smallest(d, 40)
    want_v, want_i = ops.k_smallest_ref(d, 40)
    assert torch.equal(idx, want_i)
    torch.testing.assert_close(vals, want_v, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(torch.signbit(vals), torch.signbit(want_v))


def test_fps_kernel_rejects_start_out_of_range(cuda):
    pts = cloud(10, 2, 64, 3, device=cuda)
    for bad in ([0, 64], [-1, 3]):
        with pytest.raises(ValueError, match="start_idx"):
            ops.furthest_point_sample(pts, 8, start_idx=torch.tensor(bad, device=cuda))


def test_gather_kernel_is_exact(cuda):
    pts = cloud(4, 3, 1000, 6, device=cuda)
    idx = torch.randint(0, 1000, (3, 50, 7), generator=torch.Generator().manual_seed(5))
    idx = idx.int().to(cuda)
    assert torch.equal(ops.gather_coords(pts, idx), ops.gather_points(pts, idx))
    bad = torch.tensor([[0, 1000, -1]], dtype=torch.int32, device=cuda)
    out = ops.gather_coords(pts[:1], bad)
    assert torch.isnan(out[0, 1:]).all() and torch.equal(out[0, 0], pts[0, 0])


def test_group_points_counts_launches(cuda):
    xyz = cloud(6, 4, 1024, 3, device=cuda)
    _backend.reset_launches()
    nbr, ctr = ops.group_points(xyz, 64, 32)
    assert _backend.LAUNCHES == {"fps": 1, "k_smallest": 1, "gather": 2}
    nbr_r, ctr_r = ops.group_points_ref(xyz, 64, 32)
    assert torch.equal(ctr, ctr_r) and torch.equal(nbr, nbr_r)


def test_kernels_reject_wrong_inputs(cuda):
    pts = cloud(7, 2, 64, 3, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        ops.furthest_point_sample(pts.double(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        ops.k_smallest(cloud(8, 64, 4, device=cuda).t(), 3)
    with pytest.raises(ValueError, match="int32"):
        ops.gather_coords(pts, torch.zeros(2, 4, dtype=torch.long, device=cuda))


def test_small_classifier_card_matches_cpu(cuda):
    """The f32 serving forward gives the same logits on the card (kernels)
    and on the CPU (plain versions); products are full f32 on both."""
    cfg = ConfigDict(dict(npoints=256, model=dict(
        NAME="PointTransformer", embed_dim=48, depth=2, cls_dim=10, num_heads=3,
        group_size=8, num_group=16, encoder_dims=48, transfer_type="mlp-3")))
    pts = np.random.default_rng(0).normal(size=(3, 512, 3)).astype(np.float32)
    on_card = build_infer_fn(load_model(cfg, seed=0, device=cuda), 256)(pts)
    on_cpu = build_infer_fn(load_model(cfg, seed=0, device="cpu"), 256)(pts)
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=1e-4, atol=1e-4)
