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
    assert _backend.LAUNCHES == {"fps": 1, "k_smallest": 1, "gather": 2, "gumbel_argmax": 0}
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


@pytest.mark.parametrize("B,N,S", [(4, 1024, 64), (2, 777, 130)])
def test_fps_kernel_at_start_0_covers_fps_kernel_row(cuda, B, N, S):
    """``act_tpu/ops/fps.py:29`` ``_fps_kernel`` (row-per-program FPS from
    index 0, first argmax) is ``csrc/fps.cu`` at start 0: the walk starts at
    index 0 and equals the plain version up to adjacent tie swaps."""
    pts = cloud(11, B, N, 3, device=cuda)
    got = ops.furthest_point_sample(pts, S)
    assert torch.equal(got[:, 0].cpu(), torch.zeros(B, dtype=torch.int32))
    want = ops.furthest_point_sample_ref(pts, S)
    assert tie_swaps(got, want) >= 0
    assert torch.equal(got.sort(-1).values, want.sort(-1).values)


@pytest.mark.parametrize("rows,V,dtype", [(8192, 8192, torch.bfloat16),
                                          (8192, 8192, torch.float32),
                                          (300, 1000, torch.bfloat16), (1, 8192, torch.bfloat16),
                                          (37, 1001, torch.float32)])
def test_gumbel_kernel_matches_plain(cuda, rows, V, dtype):
    """Same hash, same logf: the ids equal the plain version's exactly, on
    the vector path (V a multiple of 8 or 4) and the scalar one."""
    g = torch.Generator(device=cuda).manual_seed(rows + V)
    logits = torch.randn(rows, V, generator=g, device=cuda).to(dtype)
    for words in ([0, 1], [123456789, -5]):
        seed = torch.tensor(words, dtype=torch.int32, device=cuda)
        got = ops.gumbel_argmax(logits, seed)
        assert got.dtype == torch.int32 and got.shape == (rows,)
        assert torch.equal(got, ops.gumbel_argmax_ref(logits, seed))


def test_gumbel_kernel_unaligned_rows_and_lead_dims(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    base = torch.randn(4 * 16 * 64 + 1, generator=g, device=cuda).to(torch.bfloat16)
    logits = base[1:].reshape(4, 16, 64)  # a storage offset of one element: not 16-byte aligned
    seed = torch.tensor([3, 4], dtype=torch.int32, device=cuda)
    got = ops.gumbel_argmax(logits, seed)
    assert got.shape == (4, 16)
    assert torch.equal(got, ops.gumbel_argmax_ref(logits, seed))


def test_gumbel_kernel_counts_launches_and_rejects_wrong_inputs(cuda):
    logits = torch.zeros(8, 64, device=cuda)
    seed = torch.zeros(2, dtype=torch.int32, device=cuda)
    _backend.reset_launches()
    ops.gumbel_argmax(logits, seed)
    assert _backend.LAUNCHES["gumbel_argmax"] == 1
    with pytest.raises(ValueError, match="bf16 or float32"):
        ops.gumbel_argmax(logits.double(), seed)
    with pytest.raises(ValueError, match="contiguous"):
        ops.gumbel_argmax(torch.zeros(64, 8, device=cuda).t(), seed)
    with pytest.raises(ValueError, match="seed on"):
        ops.gumbel_argmax(logits, seed.cpu())
    with pytest.raises(ValueError, match="seed"):
        ops.gumbel_argmax(logits, seed.long())


def test_k_smallest_kernel_dgcnn_shape(cuda):
    """k=4 over N=64, the DGCNN graph of the tokenizer."""
    centers = cloud(12, 128, 64, 3, device=cuda)
    d = ops.square_distance(centers, centers).reshape(-1, 64)
    vals, idx = ops.k_smallest(d, 4)
    want_v, want_i = ops.k_smallest_ref(d, 4)
    assert torch.equal(idx, want_i) and torch.equal(vals, want_v)
    assert torch.equal(ops.graph_feature_idx(centers, centers, 4),
                       ops.graph_feature_idx_ref(centers, centers, 4))


def test_small_distillation_step_card_matches_cpu(cuda):
    """Two f32 train steps of a small ACT_PointDistillation on the card
    (kernels) and on the CPU (plain versions) from the same seed: the Gumbel
    ids, masks and dropout draws differ between the two devices' generators,
    so only finite losses and the frozen tokenizer are compared."""
    from act_tpu_torch.engine.runner_pretrain import run_steps
    cfg = ConfigDict(dict(
        optimizer=dict(type="AdamW", kwargs=dict(lr=1e-3, weight_decay=0.05)),
        scheduler=dict(type="CosLR", kwargs=dict(epochs=300, initial_epochs=10)),
        dataset=dict(train=dict(others=dict(npoints=256))), total_bs=4,
        model=dict(NAME="ACT_PointDistillation", loss="cosine",
                   transformer_config=dict(
                       mask_ratio=0.8, mask_type="rand", proj="linear", embed_dim=32,
                       encoder_dims=32, depth=2, drop_path_rate=0.1, cls_dim=32, num_heads=4,
                       decoder_depth=1, decoder_num_heads=4, cls_loss=False),
                   dvae_config=dict(group_size=8, num_group=16, encoder_dims=32,
                                    num_tokens=64, tokens_dims=32, decoder_dims=32,
                                    visual_embed_dim=48, visual_embed_depth=2,
                                    visual_embed_heads=4, num_prompt_token=4,
                                    use_deep_prompt=True))))
    _backend.reset_launches()
    card = run_steps(cfg, 2, device=cuda)
    assert all(v > 0 for v in _backend.LAUNCHES.values()), _backend.LAUNCHES
    cpu = run_steps(cfg, 2, device="cpu")
    assert all(np.isfinite(card.losses)) and all(np.isfinite(cpu.losses))
    a, b = card.model.state_dict(), cpu.model.state_dict()
    for k in a:
        if k.startswith("dvae_tokenizer.") and "running" not in k and "num_batches" not in k:
            assert torch.equal(a[k].cpu(), b[k]), k
