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
from act_tpu_torch.ops import chamfer as chamfer_mod
from act_tpu_torch.ops import gather as gather_mod
from act_tpu_torch.kernel_sweep import (BWD_RTOL, CHAMFER_SHAPES, GATHER_GEOMETRIES,
                                        GATHER_SHAPES, GUMBEL_SHAPES, chamfer_runs,
                                        gumbel_geometries, gumbel_launch)
from act_tpu_torch.ops import sampling
from act_tpu_torch.ops.fps import _sms, tie_swaps
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


@pytest.mark.parametrize("N", [8192, 1024, 777])
@pytest.mark.parametrize("B", [1, 2, 32, 33, 64, 128, 200])
def test_fps_kernel_batch_sizes_and_starts(cuda, B, N):
    """Every batch size picks its own cluster size (at N=8192: 8 at B=1 and
    2, 4 at B=32 and 33, 2 at B=64, 1 at B=128 and 200); random starts,
    picks equal up to adjacent tie swaps with the same selected set."""
    pts = cloud(30 + B, B, N, 3, device=cuda)
    start = torch.randint(0, N, (B,), generator=torch.Generator().manual_seed(B)).to(cuda)
    got = ops.furthest_point_sample(pts, 200, start_idx=start)
    want = ops.furthest_point_sample_ref(pts, 200, start)
    assert tie_swaps(got, want) >= 0
    assert torch.equal(got.sort(-1).values, want.sort(-1).values)
    assert torch.equal(got[:, 0], start.int())


def fps_geometries(N):
    """Every cluster size with 1-16 points a thread that covers N."""
    for c in (1, 2, 4, 8):
        slice_ = -(-N // c)
        for ppt in (1, 2, 4, 8, 16):
            threads = -(-slice_ // ppt)
            threads = max(32, -(-threads // 32) * 32)
            if threads <= 1024:
                yield c, threads, ppt


def launch_fps(pts, S, start, geometry):
    B, N, _ = pts.shape
    out = torch.empty(B, S, dtype=torch.int32, device=pts.device)
    _backend.launch("fps", pts, start.int(), out, B, N, S, *geometry)
    return out


@pytest.mark.parametrize("N", [8192, 1024, 777, 20])
def test_fps_kernel_every_cluster_geometry(cuda, N):
    """Each cluster size the launch may pick, at each points-a-thread count
    that covers N, walks like the plain version."""
    pts = cloud(40, 3, N, 3, device=cuda)
    start = torch.tensor([0, N // 2, N - 1], device=cuda)
    S = min(N, 100)
    want = ops.furthest_point_sample_ref(pts, S, start)
    for geo in fps_geometries(N):
        got = launch_fps(pts, S, start, geo)
        assert tie_swaps(got, want) >= 0, geo
        assert torch.equal(got.sort(-1).values, want.sort(-1).values), geo


@pytest.mark.parametrize("N", [8192, 1024, 777])
def test_fps_kernel_ties_across_cluster_blocks(cuda, N):
    """An all-equal cloud and a cloud of duplicated points: every distance
    tie, also between points in different blocks of a cluster, goes to the
    smaller index, exactly as the plain version's first argmax."""
    half = cloud(41, 2, N // 2, 3, device=cuda)
    dup = torch.cat([half, half, half[:, : N - 2 * (N // 2)]], 1).contiguous()
    same = torch.full((2, N, 3), 0.25, device=cuda)
    start = torch.tensor([0, N - 1], device=cuda)
    for pts in (dup, same):
        want = ops.furthest_point_sample_ref(pts, 64, start)
        assert torch.equal(ops.furthest_point_sample(pts, 64, start_idx=start), want)
        for geo in fps_geometries(N):
            assert torch.equal(launch_fps(pts, 64, start, geo), want), geo


def tied_rows(seed, rows, N):
    """Rows drawn from a few values whose order keys differ in each of the
    four radix digits, each value repeated many times."""
    one = np.float32(1.0).view(np.uint32)
    ladder = np.array([one, one + 1, one + 2, one + 0x100, one + 0x10000,
                       one + 0x1000000, one - 1], dtype=np.uint32).view(np.float32)
    pick = np.random.default_rng(seed).integers(0, len(ladder), size=(rows, N))
    return torch.from_numpy(ladder[pick])


@pytest.mark.parametrize("N,k", [(1024, 32), (777, 100), (300, 1), (300, 300), (64, 4)])
def test_k_smallest_kernel_many_ties_across_digits(cuda, N, k):
    d = tied_rows(N + k, 50, N).to(cuda)
    vals, idx = ops.k_smallest(d, k)
    want_v, want_i = ops.k_smallest_ref(d, k)
    assert torch.equal(idx, want_i) and torch.equal(vals, want_v)


@pytest.mark.parametrize("k", [1, 5, 37, 129])
def test_k_smallest_kernel_all_equal_rows(cuda, k):
    for fill in (0.0, -0.0, 3.5):
        d = torch.full((9, 129), fill, device=cuda)
        vals, idx = ops.k_smallest(d, k)
        assert torch.equal(idx.cpu(), torch.arange(k, dtype=torch.int32).expand(9, k))
        assert torch.equal(vals.view(torch.int32), d[:, :k].view(torch.int32))


@pytest.mark.parametrize("rows,N,k", [(6, 777, 1), (6, 777, 777), (4, 33, 33), (4, 31, 7),
                                      (3, 58112, 32), (2, 58112, 100), (2, 70001, 16)])
def test_k_smallest_kernel_edges(cuda, rows, N, k):
    """k = 1 and k = N, N not a multiple of 32, and rows too long for shared
    memory (read from device memory in each pass)."""
    d = cloud(50 + N, rows, N, device=cuda)
    vals, idx = ops.k_smallest(d, k)
    want_v, want_i = ops.k_smallest_ref(d, k)
    assert torch.equal(idx, want_i) and torch.equal(vals, want_v)


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
    """Bit-equal to ``gather_points`` for every C in 1-8 through both bodies
    (below and from 2^16 points, the last tile of a cloud ragged or not), S
    not a multiple of 4 and an index view at an odd element offset (the
    element body at any size), B = 0 and S = 0; an index outside [0, N)
    gathers NaN (``ops/gather.py`` ``check_gather_cases``)."""
    pts = cloud(4, 3, 1000, 6, device=cuda)
    idx = torch.randint(0, 1000, (3, 50, 7), generator=torch.Generator().manual_seed(5))
    idx = idx.int().to(cuda)
    assert torch.equal(ops.gather_coords(pts, idx), ops.gather_points(pts, idx))
    assert gather_mod.check_gather_cases(ops.gather_coords, cuda) == []


@pytest.mark.parametrize("shape", GATHER_SHAPES)
def test_gather_kernel_every_geometry(cuda, shape):
    """Each (body, threads) that kernel_sweep times, at each gather shape of
    the paths, into an output first filled with NaN: bit-equal."""
    B, N, S = shape
    pts = cloud(40, B, N, 3, device=cuda)
    idx = torch.randint(0, N, (B, S), generator=torch.Generator().manual_seed(41))
    idx = idx.int().to(cuda)
    want = ops.gather_points(pts, idx)
    for geo in GATHER_GEOMETRIES:
        out = torch.full((B, S, 3), float("nan"), device=cuda)
        _backend.launch("gather", pts, idx, out, B, N, S, 3, *geo)
        assert torch.equal(out, want), geo


def test_gather_kernel_rejects_an_unaligned_tile(cuda):
    """The tile body needs S a multiple of 4 and aligned views: the launch
    refuses it otherwise (the wrapper then picks the element body)."""
    pts = cloud(42, 32, 100, 3, device=cuda)
    idx = torch.zeros(32 * 2048 + 1, dtype=torch.int32, device=cuda)
    out = torch.empty(32, 2048, 3, device=cuda)
    with pytest.raises(RuntimeError, match="gather kernel launch failed"):
        _backend.launch("gather", pts, idx[1:], out, 32, 100, 2048, 3, 1, 128)
    got = ops.gather_coords(pts, idx[1:].view(32, 2048))
    assert torch.equal(got, pts[:, :1].expand(-1, 2048, -1))


def test_group_points_counts_launches(cuda):
    xyz = cloud(6, 4, 1024, 3, device=cuda)
    _backend.reset_launches()
    nbr, ctr = ops.group_points(xyz, 64, 32)
    assert _backend.LAUNCHES == {**{k: 0 for k in _backend.KERNELS},
                                 "fps": 1, "k_smallest": 1, "gather": 2}
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


@pytest.mark.parametrize("k", range(sampling.MIN_BITS, sampling.MAX_BITS + 1))
def test_gumbel_noise_bounds_hold_for_every_bits(cuda, k):
    """Over all 2^31 hash bits the card's noise() is non-decreasing and lies in
    both of its buckets' [Glo, Ghi]: the screen never drops a lane that can
    win."""
    assert sampling.bound_violations(k, cuda) == (0, 0)


@pytest.mark.parametrize("rows,V,dtype", [(8192, 8192, torch.bfloat16),
                                          (8192, 8192, torch.float32),
                                          (256, 20000, torch.float32),
                                          (8192, 1000, torch.bfloat16),
                                          (24, 20000, torch.float32),
                                          (1024, 8191, torch.bfloat16),
                                          (300, 1000, torch.bfloat16),
                                          (37, 1001, torch.float32),
                                          (512, 1024, torch.bfloat16),
                                          (512, 512, torch.float32)])
def test_gumbel_kernel_ties_nan_inf_rows(cuda, rows, V, dtype):
    """Exact ties (first index), one-step near ties in either order, an
    all-zero row, NaN and +-inf logits and u = 1 lanes: ids equal the plain
    version's and each case's own id, screened (long rows, few rows, rows of
    one tile: 1024 bf16, 512 f32) and taken exactly where the kernel does not
    screen (V = 8191 and 1001, ragged; V = 1000, below a tile)."""
    logits, seed, cases = sampling.gumbel_cases(rows, V, dtype, cuda)
    got = ops.gumbel_argmax(logits, seed)
    want = ops.gumbel_argmax_ref(logits, seed)
    assert torch.equal(got, want)
    assert sampling.check_gumbel_cases(got, want, cases) == []
    assert {"all-zero row", "NaN logit", "+inf logit", "tie, one thread",
            "tie, one warp"} <= set(cases)
    if rows * V >= 2 ** 26:
        assert {"tie, two tiles", "-inf logit on a u = 1 lane",
                "u = 1 lane wins, tied at +inf"} <= set(cases)


@pytest.mark.parametrize("rows,V,dtype", GUMBEL_SHAPES)
def test_gumbel_kernel_every_swept_geometry(cuda, rows, V, dtype):
    g = torch.Generator(device=cuda).manual_seed(rows + V)
    logits = torch.randn(rows, V, generator=g, device=cuda).to(dtype)
    seed = torch.tensor([123456789, -5], dtype=torch.int32, device=cuda)
    want = ops.gumbel_argmax_ref(logits, seed)
    out = torch.empty(rows, dtype=torch.int32, device=cuda)
    sms = _sms(cuda.index or 0)
    for geo in set(gumbel_geometries(rows, V, sms)) | {sampling.launch_geometry(rows, V, sms)}:
        out.fill_(-1)
        gumbel_launch(logits, seed, out, geo)
        assert torch.equal(out, want), geo


def test_gumbel_kernel_rejects_bad_geometry(cuda):
    logits = torch.zeros(4, 64, device=cuda)
    seed = torch.zeros(2, dtype=torch.int32, device=cuda)
    out = torch.empty(4, dtype=torch.int32, device=cuda)
    for x in (logits, torch.zeros(4, 63, device=cuda)):  # the vector and the scalar path
        for geo in ((sampling.MIN_BITS - 1, 4), (sampling.MAX_BITS + 1, 4), (0, 4), (8, 0),
                    (8, -1)):
            with pytest.raises(RuntimeError, match="launch failed"):
                gumbel_launch(x, seed, out, geo)


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
    assert _backend.LAUNCHES == {**{k: 0 for k in _backend.KERNELS}, "fps": 2, "k_smallest": 6,
                                 "gather": 4, "gumbel_argmax": 2}
    cpu = run_steps(cfg, 2, device="cpu")
    assert all(np.isfinite(card.losses)) and all(np.isfinite(cpu.losses))
    a, b = card.model.state_dict(), cpu.model.state_dict()
    for k in a:
        if k.startswith("dvae_tokenizer.") and "running" not in k and "num_batches" not in k:
            assert torch.equal(a[k].cpu(), b[k]), k


@pytest.mark.parametrize("B,N,M", [(4096, 8, 32), (4096, 32, 32), (1, 2048, 1024),
                                   (32, 2048, 2048), (3, 777, 1001), (5, 1, 40), (2, 300, 1)])
def test_chamfer_kernels_match_plain(cuda, B, N, M):
    """The recon loss's and the validation's shapes, the whole-cloud op shape,
    a ragged pair and single-point clouds: distances bit-equal and indices
    exact (both sides compute ((dx*dx + dy*dy) + dz*dz) with separate
    roundings); the backward bit-equal to the plain version run on the CPU
    for clouds of at most 32 points (the group body), else within 1e-5 of
    the largest gradient (the atomic body's sums run in a changing order)."""
    x, y = cloud(20, B, N, 3, device=cuda), cloud(21, B, M, 3, device=cuda)
    got, want = chamfer_mod.nn_pair(x, y), ops.chamfer_ref(x, y)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(chamfer_mod.nn_pair_min(x, y), ops.chamfer_min_ref(x, y)):
        assert torch.equal(a, b)
    g1, g2 = cloud(22, B, N, device=cuda), cloud(23, B, M, device=cuda)
    gb = chamfer_mod.chamfer_bwd(x, y, want[2], want[3], g1, g2)
    if max(N, M) <= chamfer_mod.BWD_GROUP_MAX:
        wb = ops.chamfer_bwd_ref(*(t.cpu() for t in (x, y, want[2], want[3], g1, g2)))
        for a, b in zip(gb, wb):
            assert torch.equal(a.cpu(), b)
    else:
        wb = ops.chamfer_bwd_ref(x, y, want[2], want[3], g1, g2)
        for a, b in zip(gb, wb):
            torch.testing.assert_close(a, b, rtol=0, atol=BWD_RTOL * float(b.abs().max()))


@pytest.mark.parametrize("name", chamfer_mod.BWD_CASES)
def test_chamfer_bwd_group_body_hard_cases(cuda, name):
    """The group body bit-equal to the plain version run on the CPU, signs of
    zeros included, on ``ops/chamfer.py`` ``bwd_case``'s hard cases; an index
    out of range makes its own row NaN and adds nothing elsewhere."""
    def on_card(*args):
        return [t.cpu() for t in chamfer_mod.chamfer_bwd(*(t.to(cuda) for t in args))]
    assert chamfer_mod.check_bwd_case(name, on_card)


def test_chamfer_kernel_ties_take_the_first_index(cuda):
    """Duplicated points: equal minima in both directions go to the first
    index, as in torch.argmin and the TPU kernel."""
    p = cloud(24, 3, 100, 3, device=cuda)
    x, y = p[:, :60].contiguous(), torch.cat([p, p, p[:, :10]], 1)
    for a, b in zip(chamfer_mod.nn_pair(x, y), ops.chamfer_ref(x, y)):
        assert torch.equal(a, b)
    i1 = chamfer_mod.nn_pair(x, y)[2]
    assert torch.equal(i1.cpu(), torch.arange(60, dtype=torch.int32).expand(3, 60))
    grid = torch.tensor([[[0.0, 0, 0], [1, 0, 0], [0, 0, 0], [1, 0, 0]]], device=cuda)
    half = torch.tensor([[[0.5, 0, 0], [1, 0, 0], [0, 0, 0]]], device=cuda)
    _, _, i1, i2 = chamfer_mod.nn_pair(half, grid)
    assert i1.tolist() == [[0, 1, 0]] and i2.tolist() == [[2, 1, 2, 1]]


def check_chamfer(x, y, geo=None):
    """chamfer_nn and chamfer_nn_min, through the wrappers or at tiling
    ``geo``: distances bit-equal to the plain versions, indices equal."""
    want = {"chamfer_nn": ops.chamfer_ref(x, y), "chamfer_nn_min": ops.chamfer_min_ref(x, y)}
    if geo is None:
        got = {"chamfer_nn": chamfer_mod.nn_pair(x, y),
               "chamfer_nn_min": chamfer_mod.nn_pair_min(x, y)}
    else:
        got = {k: run() for k, run in chamfer_runs(x, y, geo).items()}
    for k in want:
        for a, b in zip(got[k], want[k]):
            assert a.dtype == b.dtype and torch.equal(a, b), (k, geo)
    return got["chamfer_nn"]


# tilings whose tiles split both clouds of the tie and overflow cases below
SPLIT_TILINGS = [None, (64, 64, 2, 64, 1), (32, 64, 8, 64, 1), (256, 512, 8, 256, 1),
                 (512, 256, 16, 256, 1), (64, 64, 8, 64, 1)]


@pytest.mark.parametrize("geo", SPLIT_TILINGS)
def test_chamfer_kernel_ties_across_tiles(cuda, geo):
    """Equal minima in different tiles, in both directions: y repeats a cloud
    of 300 points 5 times (more than one tile of y), then x does (more than
    one tile of x). The first index wins, merged across the tiles."""
    p = cloud(30, 2, 300, 3, device=cuda)
    first = torch.arange(200, dtype=torch.int32).expand(2, 200)
    x, y = p[:, :200].contiguous(), torch.cat([p] * 5, 1)
    tt = (geo or chamfer_mod.launch_geometry(2, 200, 1500, _sms(torch.cuda.current_device())))[1]
    assert tt < 1500
    assert torch.equal(check_chamfer(x, y, geo)[2].cpu(), first)
    tq = (geo or chamfer_mod.launch_geometry(2, 1500, 200, _sms(torch.cuda.current_device())))[0]
    assert tq < 1500
    assert torch.equal(check_chamfer(y, x, geo)[3].cpu(), first)


@pytest.mark.parametrize("geo", SPLIT_TILINGS)
def test_chamfer_kernel_all_equal_clouds(cuda, geo):
    """Every distance 0: every index is 0 in both directions."""
    x, y = torch.full((3, 700, 3), 0.5, device=cuda), torch.full((3, 900, 3), 0.5, device=cuda)
    d1, d2, i1, i2 = check_chamfer(x, y, geo)
    assert not d1.any() and not d2.any() and not i1.any() and not i2.any()


@pytest.mark.parametrize("B,N,M", [(2, 1000, 333), (1, 2047, 1025), (5, 65, 129),
                                   (3, 33, 513), (4, 513, 31)])
def test_chamfer_kernels_ragged_tiles(cuda, B, N, M):
    """N and M not multiples of the tile, through the wrappers."""
    check_chamfer(cloud(31, B, N, 3, device=cuda), cloud(32, B, M, 3, device=cuda))


@pytest.mark.parametrize("shape", list(CHAMFER_SHAPES))
def test_chamfer_kernels_every_swept_tiling(cuda, shape):
    """Each tiling that kernel_sweep times, at its shape (the 4096 group
    problems of the recon loss at full B; the large shapes at fewer clouds)."""
    B, N, M = shape
    B = B if N * M <= 4096 else min(B, 2)
    x, y = cloud(33, B, N, 3, device=cuda), cloud(34, B, M, 3, device=cuda)
    for geo in CHAMFER_SHAPES[shape]:
        check_chamfer(x, y, geo)


@pytest.mark.parametrize("geo", SPLIT_TILINGS)
def test_chamfer_kernel_distances_overflow_to_inf(cuda, geo):
    """Coordinates near 1e19: the squared distances overflow to inf. The
    merge keys still order them: all-inf rows take index 0, as the plain
    version does; mixed with finite distances, finite ones win."""
    a = 2e19 + 1e18 * cloud(35, 2, 300, 3, device=cuda)
    b = cloud(36, 2, 400, 3, device=cuda)
    d1 = check_chamfer(torch.cat([a, b[:, :200]], 1), b, geo)[0]
    assert torch.isinf(d1[:, :300]).all() and torch.isfinite(d1[:, 300:]).all()
    d1, d2, i1, i2 = check_chamfer(a, -2e19 + 1e18 * b, geo)
    assert torch.isinf(d1).all() and torch.isinf(d2).all() and not i1.any() and not i2.any()


def test_chamfer_distances_forward_backward_match_plain(cuda):
    """The autograd function on the card (chamfer_nn, chamfer_bwd) against
    the plain path (the same function on the CPU): L1 and L2 losses and
    their gradients."""
    for fn in (ops.chamfer_distance_l1, ops.chamfer_distance_l2):
        x, y = cloud(25, 64, 32, 3, device=cuda), cloud(26, 64, 32, 3, device=cuda)
        xs = [x.clone().requires_grad_(), x.cpu().requires_grad_()]
        ys = [y.clone().requires_grad_(), y.cpu().requires_grad_()]
        _backend.reset_launches()
        out = [fn(a, b) for a, b in zip(xs, ys)]
        for o in out:
            o.backward()
        assert _backend.LAUNCHES["chamfer_nn"] == 1 and _backend.LAUNCHES["chamfer_bwd"] == 1
        torch.testing.assert_close(out[0].cpu(), out[1], rtol=1e-6, atol=0)
        for a, b in ((xs[0].grad, xs[1].grad), (ys[0].grad, ys[1].grad)):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5 * float(b.abs().max()))
    with torch.no_grad():
        _backend.reset_launches()
        ops.chamfer_distances(x, y)
    assert _backend.LAUNCHES["chamfer_nn_min"] == 1 and _backend.LAUNCHES["chamfer_nn"] == 0


def test_chamfer_kernels_reject_wrong_inputs(cuda):
    x = cloud(27, 2, 16, 3, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        ops.chamfer_distances(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.chamfer_distances(x.transpose(0, 1), x.transpose(0, 1))
    with pytest.raises(ValueError, match="x on"):
        ops.chamfer_distances(x, x.cpu())


def test_small_autoencoder_steps_card_matches_cpu(cuda):
    """Two f32 Stage-I steps of a small dVAE on the card (kernels) and on the
    CPU (plain versions) from the same seed: the Gumbel and dropout draws
    differ between the two devices' generators, so only finite losses and the
    frozen teacher backbone are compared; then the metrics."""
    from act_tpu_torch.engine.runner_autoencoder import run_autoencoder_steps, validate
    cfg = ConfigDict(dict(
        optimizer=dict(type="AdamW", kwargs=dict(lr=5e-4, weight_decay=5e-4)),
        scheduler=dict(type="CosLR", kwargs=dict(epochs=300, initial_epochs=10)),
        dataset=dict(train=dict(others=dict(npoints=256))), total_bs=4, grad_norm_clip=10,
        temp=dict(start=1, target=0.0625, ntime=100000),
        kldweight=dict(start=0, target=0.1, ntime=100000),
        model=dict(NAME="ACTPromptedDiscreteVAEwithVIT", group_size=8, num_group=16,
                   encoder_dims=32, num_tokens=64, tokens_dims=32, decoder_dims=32,
                   visual_embed_dim=48, visual_embed_depth=2, visual_embed_heads=4,
                   num_prompt_token=4, use_deep_prompt=True, freeze_visual_embed=True)))
    _backend.reset_launches()
    card = run_autoencoder_steps(cfg, 2, device=cuda, start_itr=60000)
    assert _backend.LAUNCHES == {**{k: 0 for k in _backend.KERNELS}, "fps": 2, "k_smallest": 6,
                                 "gather": 4, "chamfer_nn": 4, "chamfer_bwd": 4,
                                 "row_gather_bwd": 16}
    cpu = run_autoencoder_steps(cfg, 2, device="cpu", start_itr=60000)
    assert all(np.isfinite(card.losses)) and all(np.isfinite(cpu.losses))
    a, b = card.model.state_dict(), cpu.model.state_dict()
    for k in a:
        if k.startswith("visual_embed."):
            assert torch.equal(a[k].cpu(), b[k]), k
    clouds = [cloud(28 + i, 256, 3, device=cuda) for i in range(2)]
    _backend.reset_launches()
    metrics, per_cloud = validate(card.model, clouds)
    assert _backend.LAUNCHES["chamfer_nn_min"] == 2  # one a cloud for all three metrics
    assert all(np.isfinite(v) for row in per_cloud for v in row)


@pytest.mark.parametrize("B,N,n_fps,n_out", [(32, 8192, 1200, 1024), (3, 777, 300, 256),
                                             (64, 8192, 1200, 1024), (2, 256, 300, 100)])
def test_fps_subsample_kernels_match_plain(cuda, B, N, n_fps, n_out):
    """The finetune resample on the card: FPS picks equal to the plain
    version's up to adjacent tie swaps; without a swap the kept points are
    the plain composition's bit for bit (the index compose through the
    gather kernel, then the cloud gather); n_fps >= N skips FPS."""
    from act_tpu_torch.ops.group import subset_draw
    pts = cloud(40 + B, B, N, 3, device=cuda)
    sub = subset_draw(B, min(n_fps, N), n_out, torch.Generator(device=cuda).manual_seed(3), cuda)
    _backend.reset_launches()
    got = ops.fps_subsample_by(pts, n_fps, sub)
    torch.cuda.synchronize()
    assert got.shape == (B, n_out, 3)
    if n_fps >= N:
        assert _backend.LAUNCHES["fps"] == 0 and _backend.LAUNCHES["gather"] == 1
        assert torch.equal(got, ops.gather_points(pts, sub))
        return
    assert _backend.LAUNCHES["fps"] == 1 and _backend.LAUNCHES["gather"] == 2
    picks = ops.furthest_point_sample_ref(pts, n_fps)
    n_sw = tie_swaps(ops.furthest_point_sample(pts, n_fps), picks)
    assert n_sw >= 0
    if n_sw == 0:
        assert torch.equal(got, ops.gather_points(pts, torch.gather(picks, 1, sub.long())))
    drawn = ops.fps_subsample(pts, n_fps, n_out, torch.Generator(device=cuda).manual_seed(3))
    assert torch.equal(drawn, got)


@pytest.mark.parametrize("B,S", [(3, 9), (32, 1024), (64, 2048)])
def test_index_compose_through_the_gather_kernel_is_bit_exact(cuda, B, S):
    """int32 indices viewed as f32, gathered by the kernel (the element body,
    and the tile body at 2^17 points), and viewed back: equal to an integer
    torch.gather, including denormal bit patterns (indices below 2^23) and
    indices above 2^23, 2^24 and up to 2^31 - 1."""
    g = torch.Generator().manual_seed(B)
    table = torch.randint(0, 2 ** 31 - 1, (B, 1500), generator=g, dtype=torch.int32)
    table[:, :8] = torch.tensor([0, 1, 5, 8191, 2 ** 23 - 1, 2 ** 23 + 1, 2 ** 24 + 3,
                                 2 ** 31 - 1], dtype=torch.int32)
    table = table.to(cuda)
    idx = torch.randint(0, 1500, (B, S), generator=g, dtype=torch.int32)
    idx[:, :8] = torch.arange(8, dtype=torch.int32)
    idx = idx.to(cuda)
    out = ops.gather_coords(table.view(torch.float32)[:, :, None], idx)
    assert torch.equal(out[:, :, 0].view(torch.int32), torch.gather(table, 1, idx.long()))


def test_small_finetune_step_on_the_card(cuda):
    """Three f32 finetune steps of a small classifier on the card: the
    kernels' launches, finite losses, every trainable tensor and the BN
    running statistics moved; then validate and one vote batch."""
    from act_tpu_torch.datasets import DataLoader, build_dataset_from_cfg
    from act_tpu_torch.engine.runner_finetune import (build_state, run_finetune_steps,
                                                      validate, validate_vote)
    node = {"_base_": dict(NAME="ModelNet", DATA_PATH="data/absent", N_POINTS=256,
                           NUM_CATEGORY=40), "others": {"subset": "train"}}
    cfg = ConfigDict(dict(
        optimizer=dict(type="AdamW", kwargs=dict(lr=5e-4, weight_decay=0.05)),
        scheduler=dict(type="CosLR", kwargs=dict(epochs=300, initial_epochs=10)),
        grad_norm_clip=10, total_bs=4, npoints=128,
        dataset=dict(train=node, val=dict(node, others=dict(subset="test"))),
        model=dict(NAME="PointTransformer", embed_dim=32, depth=2, drop_path_rate=0.1,
                   cls_dim=40, num_heads=4, group_size=8, num_group=16, encoder_dims=32,
                   transfer_type="full")))
    st = build_state(cfg, 128, seed=0, device=cuda)
    before = {k: v.detach().clone() for k, v in st.model.state_dict().items()}
    _backend.reset_launches()
    run = run_finetune_steps(cfg, 3, device=cuda, state=st)
    assert _backend.LAUNCHES == {**{k: 0 for k in _backend.KERNELS}, "fps": 6,
                                 "k_smallest": 3, "gather": 12}
    assert all(np.isfinite(run.losses))
    after = st.model.state_dict()
    for n, p in st.model.named_parameters():
        assert torch.equal(after[n], before[n]) != p.requires_grad, n
    assert all(not torch.equal(after[k], before[k]) for k in after if "running" in k)
    ds = build_dataset_from_cfg(ConfigDict(dict(node, others=dict(subset="test"))))
    batches = [b for _, b in zip(range(2), DataLoader(ds, 8))]
    acc = validate(st.model, batches, 128, cuda)
    assert np.isfinite(acc.acc) and np.isfinite(acc.macc)
    assert np.isfinite(validate_vote(st.model, batches[:1], 128, device=cuda))


# ---------------------------------------------------------------------------
# the Stage-I / Stage-II trainers' new launch shapes and the loader's workers
# ---------------------------------------------------------------------------

def test_probe_resample_launch_shapes_match_plain(cuda):
    """The SVM probe's resample at B=256: FPS (256, 8192)->1024 equal up to
    tie swaps with the same set, the gather of the picks bit-equal, then the
    grouping's FPS (256, 1024)->64 and its gathers by (256, 64) and by
    (256, 2048) bit-equal."""
    clouds = cloud(11, 256, 8192, 3, device=cuda)
    k, r = ops.furthest_point_sample(clouds, 1024), ops.furthest_point_sample_ref(clouds, 1024)
    assert tie_swaps(k, r) >= 0 and torch.equal(k.sort(-1).values, r.sort(-1).values)
    pts = ops.gather_coords(clouds, r)
    assert torch.equal(pts, ops.gather_points(clouds, r))
    kc, rc = ops.furthest_point_sample(pts, 64), ops.furthest_point_sample_ref(pts, 64)
    assert tie_swaps(kc, rc) >= 0 and torch.equal(kc.sort(-1).values, rc.sort(-1).values)
    nbr = ops.k_smallest_ref(ops.square_distance(ops.gather_points(pts, rc), pts)
                             .reshape(256 * 64, 1024), 32)[1].reshape(256, 64 * 32)
    for idx in (rc, nbr):
        assert torch.equal(ops.gather_coords(pts, idx), ops.gather_points(pts, idx))


def test_probe_k_smallest_shape_matches_plain(cuda):
    """k-smallest (16384, 1024) k=32, the probe's group kNN at B=256:
    indices exact, values bit-equal."""
    d = cloud(12, 16384, 1024, device=cuda).abs()
    (kv, ki), (rv, ri) = ops.k_smallest(d, 32), ops.k_smallest_ref(d, 32)
    assert torch.equal(ki, ri) and torch.equal(kv, rv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gumbel_kernel_at_one_validation_cloud(cuda, dtype):
    """The Gumbel kernel at one Stage-I validation cloud's logits, (64, 8192):
    ids equal the plain version's."""
    logits = cloud(13, 64, 8192, device=cuda).to(dtype)
    for words in ([0, 0], [7, -3]):
        seed = torch.tensor(words, dtype=torch.int32, device=cuda)
        assert torch.equal(ops.gumbel_argmax(logits, seed), ops.gumbel_argmax_ref(logits, seed))


def test_worker_pool_after_cuda_init(cuda, tmp_path):
    """Forked loader workers after the card is in use: they run numpy only
    and return the batches of one process, each cloud the same points."""
    from act_tpu_torch.datasets import DataLoader, build_dataset_from_cfg
    torch.ones(4, device=cuda).sum().item()  # the CUDA context exists before the fork
    rng = np.random.default_rng(0)
    data, pc = tmp_path / "ShapeNet-55", tmp_path / "shapenet_pc"
    data.mkdir()
    pc.mkdir()
    names = [f"0269115{i % 3}-m{i:03d}.npy" for i in range(12)]
    for n in names:
        np.save(pc / n, rng.normal(size=(256, 3)).astype(np.float32))
    (data / "train.txt").write_text("".join(n + "\n" for n in names))
    node = ConfigDict({"_base_": dict(NAME="ShapeNet", N_POINTS=256, DATA_PATH=str(data),
                                      PC_PATH=str(pc)),
                       "others": dict(subset="train", npoints=256)})
    one = list(DataLoader(build_dataset_from_cfg(node), 4, shuffle=True, seed=2))
    pool = DataLoader(build_dataset_from_cfg(node), 4, shuffle=True, seed=2, num_workers=2)
    try:
        got = list(pool)
    finally:
        pool.close()
    assert len(got) == len(one) == 3
    for (gt, _, gp), (wt, _, wp) in zip(got, one):
        assert list(gt) == list(wt)
        for a, b in zip(gp, wp):
            np.testing.assert_allclose(a[np.lexsort(a.T)], b[np.lexsort(b.T)], atol=1e-6)
    assert torch.cuda.is_available() and torch.ones(2, device=cuda).sum().item() == 2.0


# ---------------------------------------------------------------------------
# the segmentation path's shapes
# ---------------------------------------------------------------------------

def seg_distances(B, N, G, device):
    """The segmentation path's two distance matrices from a cloud and its FPS
    centers: (B * N, G) for the 3-NN (every center is one of the points, so
    each center's own row holds a near-0 entry) and (B * G, N) for the group
    kNN; and the points and centers."""
    pts = cloud(70 + B, B, N, 3, device=device)
    centers = ops.gather_points(pts, ops.furthest_point_sample_ref(pts, G))
    return (ops.square_distance(pts, centers).reshape(B * N, G),
            ops.square_distance(centers, pts).reshape(B * G, N), pts, centers)


@pytest.mark.parametrize("B", [16, 32])
def test_k_smallest_kernel_segmentation_shapes(cuda, B):
    """k = 3 on rows of 128 centers (the 3-NN, rows above 64 take the radix
    select) with exact-zero, all-tied and two-valued rows added, and k = 32
    on rows of 2048 (the group kNN): indices exact, values bit-equal."""
    d3, d32, _, _ = seg_distances(B, 2048, 128, cuda)
    d3[0] = 0.0
    d3[1] = 1.5
    d3[2, ::2] = 0.25
    d3[3, 5] = d3[3, 9] = d3[3, 77] = 0.0
    d3[4, 100:] = -0.0
    for d, k in ((d3, 3), (d32, 32)):
        vals, idx = ops.k_smallest(d, k)
        want_v, want_i = ops.k_smallest_ref(d, k)
        assert torch.equal(idx, want_i)
        assert torch.equal(vals.view(torch.int32), want_v.view(torch.int32))
    assert ops.k_smallest(d3, 3)[1][3].tolist() == [5, 9, 77]


@pytest.mark.parametrize("B", [1, 16, 32])
def test_fps_kernel_segmentation_shape(cuda, B):
    pts = cloud(80 + B, B, 2048, 3, device=cuda)
    got, want = ops.furthest_point_sample(pts, 128), ops.furthest_point_sample_ref(pts, 128)
    assert tie_swaps(got, want) >= 0
    assert torch.equal(got.sort(-1).values, want.sort(-1).values)


def test_three_nn_interpolate_kernel_path_matches_plain(cuda):
    """At the part-seg shapes (16 clouds of 2048 points, 128 FPS centers,
    1152 features): the kernel path launches the k-smallest kernel once in
    its forward and the row-gather backward three times in its backward, and
    gives the plain path's values and feature gradients bit for bit (the same
    indices, the same gathers, the same ascending sums); the gradients to both
    coordinate arguments within 1e-5 of each one's largest (the coordinate
    gathers' backward adds by atomics, in a changing order)."""
    _, _, pts, centers = seg_distances(16, 2048, 128, cuda)
    feats = cloud(90, 16, 128, 1152, device=cuda)
    g = cloud(91, 16, 2048, 1152, device=cuda)

    def run(plain):
        u, k, f = (t.clone().requires_grad_() for t in (pts, centers, feats))
        _backend.reset_launches()
        out = (ops.three_nn_interpolate_ref if plain else ops.three_nn_interpolate)(u, k, f)
        launches = dict(_backend.LAUNCHES)
        out.backward(g)
        torch.cuda.synchronize()
        return (out.detach(), [t.grad for t in (u, k, f)], launches,
                _backend.LAUNCHES["row_gather_bwd"])
    out_k, grads_k, launches, bwd = run(False)
    out_p, grads_p, plain_launches, plain_bwd = run(True)
    assert launches == {**{k: 0 for k in _backend.KERNELS}, "k_smallest": 1}
    assert bwd == 3 and plain_bwd == 0
    assert not any(plain_launches.values())
    assert torch.equal(out_k, out_p)
    assert torch.equal(grads_k[2], grads_p[2])
    for a, b in zip(grads_k, grads_p):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("task", ["partseg", "semseg"])
def test_small_seg_model_card_matches_cpu(cuda, task):
    """The f32 segmentation serving forward gives the same log-probs on the
    card (kernels) and on the CPU (plain versions)."""
    from act_tpu_torch.engine.serve import load_seg_model
    pts = np.random.default_rng(1).normal(size=(3, 256, 3)).astype(np.float32)
    extra = (np.eye(16, dtype=np.float32)[[0, 4, 15]],) if task == "partseg" else ()
    out = [build_infer_fn(load_seg_model(task, num_group=16, dtype="f32", device=dev), 256,
                          with_fps=False)(pts, *extra).cpu() for dev in (cuda, "cpu")]
    torch.testing.assert_close(out[0], out[1], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# ACT_PointBERT's call sites
# ---------------------------------------------------------------------------

def small_pointbert(device):
    """A small f32 ACT_PointBERT (2 blocks 32 wide, G=16 groups of 8, a
    64-way lm_head, K=8) from seed 0, the tokenizer and k frozen, on
    ``device``; and its config."""
    from act_tpu_torch.engine import runner_pretrain
    dvae = dict(NAME="ACTPromptedDiscreteVAEwithVIT", group_size=8, num_group=16,
                encoder_dims=32, num_tokens=64, tokens_dims=32, decoder_dims=32,
                visual_embed_dim=48, visual_embed_depth=2, visual_embed_heads=4,
                num_prompt_token=4, use_deep_prompt=True, visual_embed_pos="after_dgcnn1",
                freeze_visual_embed=True, visual_embed_type="vit_tiny")
    tc = dict(mask_ratio=[0.25, 0.45], mask_type="rand", embed_dim=32, encoder_dims=32,
              depth=2, drop_path_rate=0.1, cls_dim=32, replace_pob=0.0, num_heads=4,
              return_all_tokens=False, moco_loss=True, dvae_loss=True, cutmix_loss=True)
    cfg = ConfigDict(dict(model=dict(NAME="ACT_PointBERT", m=0.999, T=0.07, K=8,
                                     transformer_config=tc, dvae_config=dvae,
                                     frozen_bf16=False)))
    model = runner_pretrain.build_pretrain_model(cfg.model, seed=0)
    return runner_pretrain.freeze_tokenizer(model, cfg).to(device), cfg


def test_pointbert_eval_features_kernels_match_plain(cuda, monkeypatch):
    """``forward_eval`` features through the kernels (FPS, k-smallest, two
    gathers, each launched once) equal the plain path's bit for bit on clouds
    without FPS tie swaps."""
    from act_tpu_torch.engine.serve import build_features_fn
    model, _ = small_pointbert(cuda)
    pts = cloud(100, 4, 256, 3, device=cuda)
    assert tie_swaps(ops.furthest_point_sample(pts, 16), ops.furthest_point_sample_ref(pts, 16)) == 0
    features = build_features_fn(model.eval(), 256)
    _backend.reset_launches()
    got = features(pts)
    assert dict(_backend.LAUNCHES) == {**{k: 0 for k in _backend.KERNELS}, "fps": 1,
                                       "k_smallest": 1, "gather": 2}
    monkeypatch.setattr(ops, "group_points", ops.group_points_ref)
    assert torch.equal(got, features(pts))


def test_pointbert_train_labels_kernels_match_plain(cuda, monkeypatch):
    """The train-mode forward's token labels (the tokenizer's argmax after the
    group kNN and dgcnn_1's k=4 kNN, both through the k-smallest kernel) equal
    the plain path's, and so do the three losses; one FPS, two k-smallest and
    two gather launches."""
    from act_tpu_torch.engine.train_state import step_rngs
    model, _ = small_pointbert(cuda)
    model.train()
    pts = cloud(101, 4, 256, 3, device=cuda)
    queue = model.queue.clone()
    labels = []
    tokenize = model.dvae.forward_tokenizer
    monkeypatch.setattr(model.dvae, "forward_tokenizer",
                        lambda n, c: labels.append(tokenize(n, c)) or labels[-1])

    def losses():
        model.queue.copy_(queue)
        with torch.no_grad():
            return torch.stack(model(pts, rngs=step_rngs(0, 0, cuda)))
    _backend.reset_launches()
    got = losses()
    assert dict(_backend.LAUNCHES) == {**{k: 0 for k in _backend.KERNELS}, "fps": 1,
                                       "k_smallest": 2, "gather": 2}
    monkeypatch.setattr(ops, "group_points", ops.group_points_ref)
    monkeypatch.setattr(ops, "graph_feature_idx", ops.graph_feature_idx_ref)
    want = losses()
    assert torch.equal(labels[0], labels[1])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_pointbert_ema_matches_host_recomputation(cuda):
    """After a train step with ``ema_momentum`` the k encoder equals
    k * m + q * (1 - m) recomputed on the host from the previous k and the
    new q, within one f32 ulp; the queue pointer advanced by B."""
    from act_tpu_torch.engine.train_state import pretrain_step, step_rngs
    model, cfg = small_pointbert(cuda)
    m = float(cfg.model.m)
    opt = torch.optim.AdamW([p for p in model.parameters() if p.requires_grad], lr=1e-3)
    pts = cloud(102, 4, 256, 3, device=cuda)
    k_old = {n: p.detach().cpu().clone() for n, p in model.transformer_k.named_parameters()}
    pretrain_step(model, opt, lambda s: 1e-3, pts, 0, step_rngs(0, 0, cuda), ema_momentum=m)
    q_new = {n: p.detach().cpu() for n, p in model.transformer_q.named_parameters()}
    for n, p in model.transformer_k.named_parameters():
        host = k_old[n] * m + q_new[n] * (1.0 - m)
        ulp = torch.from_numpy(np.spacing(host.abs().numpy()))
        assert ((p.detach().cpu() - host).abs() <= ulp).all(), n
    assert int(model.queue_ptr) == 4


@pytest.mark.parametrize("op", ["fps", "k_smallest", "gather"])
def test_kernel_ops_opcheck_on_the_card(cuda, op):
    """``torch.library.opcheck`` of each registered kernel op on CUDA
    tensors: the fake implementation's shapes, dtypes and strides against
    the kernel's outputs, the schema, and a symbolic trace."""
    pts = cloud(70, 3, 50, 3, device=cuda)
    args = {"fps": (pts, torch.tensor([0, 4, 49], dtype=torch.int32, device=cuda), 9),
            "k_smallest": (cloud(71, 3, 5, 50, device=cuda), 4),
            "gather": (pts, torch.randint(0, 50, (3, 7, 2), device=cuda).int())}[op]
    torch.library.opcheck(getattr(torch.ops.act_tpu_torch, op), args)


def test_small_classifier_artifact_keeps_the_kernels(cuda, tmp_path):
    """A small classifier exported on the card with a symbolic batch holds
    the three kernel ops, reloads through ``load_exported``, launches each
    kernel, and equals the direct serving function bit for bit at B=1 and
    3; a fixed batch of 3 too."""
    from act_tpu_torch.engine import export as ex

    cfg = ConfigDict(dict(npoints=64, model=dict(
        NAME="PointTransformer", embed_dim=48, depth=2, cls_dim=10, num_heads=3,
        group_size=8, num_group=16, encoder_dims=48, transfer_type="mlp-3", dtype="bf16")))
    infer = build_infer_fn(load_model(cfg, seed=0, device=cuda), 64)
    for batch in (None, 3):
        dst = str(tmp_path / f"cls-{batch}.pt2")
        side = ex.save_exported(ex.export_classifier(cfg, batch=batch, n_in=100, device=cuda),
                                dst)
        assert side["needs_ops"] and side["device"] == "cuda"
        art = ex.load_exported(dst)
        for b in ((1, 3) if batch is None else (3,)):
            x = cloud(72 + b, b, 100, 3, device=cuda)
            _backend.reset_launches()
            got = art(x)
            torch.cuda.synchronize()
            assert all(_backend.LAUNCHES[k] > 0 for k in ("fps", "k_smallest", "gather"))
            assert torch.equal(got, infer(x))


def test_tsne_embed_on_the_card(cuda):
    """``utils/tsne.embed`` on the card: finite, the same embedding twice,
    its final KL within 5 % of a CPU run's on the same features."""
    from act_tpu_torch.utils import tsne

    rng = np.random.default_rng(3)
    feats = (rng.normal(size=(6, 64))[rng.integers(0, 6, 300)] * 3
             + rng.normal(size=(300, 64))).astype(np.float32)
    a, b = tsne.embed(feats, cuda), tsne.embed(feats, cuda)
    assert np.isfinite(a.y).all() and np.array_equal(a.y, b.y)
    cpu = tsne.embed(feats, "cpu")
    assert abs(a.kl - cpu.kl) <= 0.05 * cpu.kl


def test_gumbel_kernel_at_a_folded_rank_seed(cuda):
    """Rank 1 of a data-parallel run folds its index into seed word 0
    (``sampling.fold_seed``): the kernel's ids at that seed equal the plain
    version's, and differ from rank 0's."""
    g = torch.Generator(device=cuda).manual_seed(11)
    logits = torch.randn(4096, 8192, generator=g, device=cuda).to(torch.bfloat16)
    seed = torch.tensor([123456789, -5], dtype=torch.int32, device=cuda)
    folded = sampling.fold_seed(seed, 1)
    got = ops.gumbel_argmax(logits, folded)
    assert torch.equal(got, ops.gumbel_argmax_ref(logits, folded))
    assert not torch.equal(got, ops.gumbel_argmax(logits, seed))


def test_nccl_one_rank_all_reduce_and_global_batchnorm(cuda):
    """A one-rank NCCL group: the gradient all-reduce leaves the tensors bit
    for bit, the start-weight broadcast too, and the global statistics of a
    BatchNorm (the sums path) equal the one-process ones within 1e-5."""
    import socket

    import torch.distributed as dist

    from act_tpu_torch import parallel
    from act_tpu_torch.models import common

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    x = cloud(90, 64, 1024, 32, device=cuda) * 2 + 3
    bn = common.BatchNorm(32).to(cuda).train()
    mean, var = common._fast_stats(x, (0, 1))
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        grads = [cloud(91, 1000, device=cuda), cloud(92, 7, 3, device=cuda)]
        before = [t.clone() for t in grads]
        parallel.all_reduce_mean(grads)
        assert all(torch.equal(a, b) for a, b in zip(grads, before))
        sd = {k: v.clone() for k, v in bn.state_dict().items()}
        parallel.broadcast_module(bn)
        assert all(torch.equal(v, sd[k]) for k, v in bn.state_dict().items())
        sums = parallel.all_reduce_sum(torch.cat([x.sum((0, 1)), x.square().sum((0, 1))]))
        torch.testing.assert_close(sums[:32] / x[..., 0].numel(), mean, rtol=1e-5, atol=1e-5)
        got_var = sums[32:] / x[..., 0].numel() - (sums[:32] / x[..., 0].numel()).square()
        torch.testing.assert_close(got_var, var, rtol=1e-4, atol=1e-4)
        y = bn(x)  # one rank: the one-process statistics themselves
        torch.testing.assert_close(y, common._normalize(x, mean, var, bn.eps, bn.weight,
                                                        bn.bias), rtol=0, atol=0)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the row-gather backward (csrc/rows.cu): a fixed order of sums
# ---------------------------------------------------------------------------

def dgcnn_rows(B, G, k, device):
    """The DGCNN's (B, G * k) neighbour indices of FPS-free random centers."""
    c = cloud(95 + G, B, G, 3, device=device)
    return ops.graph_feature_idx(c, c, k).reshape(B, G * k)


ROW_SHAPES = {  # name -> (B, M, S, C): the Stage-I DGCNN's four rounds, one 3-NN gather
    **{f"dgcnn C={C}": (64, 256, 64, C) for C in (128, 256, 512)},
    "3-NN": (16, 2048, 128, 1152)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(ROW_SHAPES))
def test_row_gather_bwd_kernel_matches_plain(cuda, name, dtype):
    """At the Stage-I DGCNN's and part seg's 3-NN shapes, in f32 and bf16:
    the kernel bit-equal to its plain version on the card and on the CPU,
    and to itself across two launches (the first lists the sources of a
    shared ``ops.row_index``, the second reads that list) and at a fresh
    index; each launch counted."""
    B, M, S, C = ROW_SHAPES[name]
    if name == "3-NN":
        _, _, pts, centers = seg_distances(B, M, S, cuda)
        idx = ops.knn(centers, pts, 3)[1][:, :, 1].contiguous()
    else:
        idx = dgcnn_rows(B, S, M // S, cuda)
    grad = cloud(96, B, M, C, device=cuda).to(dtype)
    _backend.reset_launches()
    shared = ops.row_index(idx, S)
    got = ops.gather_rows_bwd(grad, shared)
    again = ops.gather_rows_bwd(grad, shared)
    fresh = ops.gather_rows_bwd(grad, ops.row_index(idx, S))
    torch.cuda.synchronize()
    assert _backend.LAUNCHES["row_gather_bwd"] == 3
    want = ops.gather_rows_bwd_ref(grad, idx, S)
    assert got.dtype == dtype and got.shape == (B, S, C)
    assert torch.equal(got, want) and torch.equal(got, again) and torch.equal(got, fresh)
    assert torch.equal(got.cpu(), ops.gather_rows_bwd_ref(grad.cpu(), idx.cpu(), S))


@pytest.mark.parametrize("case", ["one row", "out of range", "no sources", "ragged C",
                                  "signed zeros, nan, mixed magnitudes", "one cloud",
                                  "2000 rows"])
def test_row_gather_bwd_kernel_hard_cases(cuda, case):
    """Every source on one row; indices past the end and below 0 (they add
    nothing); M = 0 (zeros); C = 37 and 1; -0, NaN and magnitudes 1e-30 to
    1e30; B = 1 with S = 8192 (one warp lists the sources); S = 2000 (six
    warps): bit-equal to the plain version on the card, signs of zeros
    included, and across two launches at one index."""
    gen = torch.Generator().manual_seed(7)
    B, M, S, C = 4, 300, 50, 64
    if case == "ragged C":
        C = 37
    if case == "no sources":
        M = 0
    if case == "one cloud":
        B, M, S, C = 1, 5000, 8192, 1
    if case == "2000 rows":
        B, M, S, C = 2, 3000, 2000, 16
    idx = torch.randint(0, S, (B, M), generator=gen, dtype=torch.int32)
    grad = torch.randn(B, M, C, generator=gen)
    if case == "one row":
        idx.fill_(3)
    elif case == "out of range":
        idx[0, :40], idx[1, 40:80] = S, -1
    elif case == "signed zeros, nan, mixed magnitudes":
        grad = grad * 10.0 ** torch.randint(-30, 31, grad.shape, generator=gen).float()
        grad[:, ::3] = -0.0
        grad[2, 5, 7] = float("nan")
    for dtype in (torch.float32, torch.bfloat16):
        g, i = grad.to(dtype).to(cuda), idx.to(cuda)
        shared = ops.row_index(i, S)
        got, want = ops.gather_rows_bwd(g, shared), ops.gather_rows_bwd_ref(g, i, S)
        assert torch.equal(ops.gather_rows_bwd(g, shared).isnan(), got.isnan()), (case, dtype)
        torch.cuda.synchronize()
        assert torch.equal(got.isnan(), want.isnan()), (case, dtype)
        got, want = torch.nan_to_num(got.float()), torch.nan_to_num(want.float())
        assert torch.equal(got, want) and torch.equal(got.signbit(), want.signbit()), (case, dtype)


def test_dgcnn_rounds_share_one_listing_and_match_plain(cuda):
    """A full-width DGCNN (B=8, G=64) forward + backward on the card: its four
    rounds make one ``ops.row_index``, whose sources the first of the four
    backward launches lists and the other three read; the input's gradient
    bit-equal to the plain version's (``ops.gather_rows_ref``)."""
    from act_tpu_torch.models.common import DGCNN, init_weights
    net = DGCNN(128, 256)
    init_weights(net, torch.Generator().manual_seed(0))
    net = net.to(cuda)
    f0, coor = cloud(98, 8, 64, 128, device=cuda), cloud(99, 8, 64, 3, device=cuda)
    made, row_index = [], ops.row_index

    def spy(idx, rows):
        made.append(row_index(idx, rows))
        return made[-1]

    def grad(**patch):
        f = f0.clone().requires_grad_()
        old = {k: getattr(ops, k) for k in patch}
        for k, v in patch.items():
            setattr(ops, k, v)
        try:
            net(f, coor).square().sum().backward()
        finally:
            for k, v in old.items():
                setattr(ops, k, v)
        torch.cuda.synchronize()
        return f.grad
    _backend.reset_launches()
    got = grad(row_index=spy)
    assert _backend.LAUNCHES["row_gather_bwd"] == 4
    assert len(made) == 1 and made[0].csr is not None
    assert torch.isfinite(got).all() and torch.equal(got, grad(gather_rows=ops.gather_rows_ref))


def test_row_gather_bwd_kernel_rejects_wrong_inputs(cuda):
    grad = torch.zeros(2, 6, 4, device=cuda)
    idx = torch.zeros(2, 6, dtype=torch.int32, device=cuda)
    for bad in (lambda: ops.gather_rows_bwd(grad.half(), ops.RowIndex(idx, 3)),
                lambda: ops.gather_rows_bwd(grad, ops.RowIndex(idx.long(), 3)),
                lambda: ops.gather_rows_bwd(grad, ops.RowIndex(idx[:, :5], 3)),
                lambda: ops.gather_rows_bwd(grad, ops.RowIndex(idx, 9000)),
                lambda: ops.gather_rows_bwd(grad.transpose(1, 2).contiguous().transpose(1, 2),
                                            ops.RowIndex(idx, 3))):
        with pytest.raises(ValueError):
            bad()


def test_small_stage1_and_partseg_steps_repeat_bit_for_bit(cuda):
    """Two f32 steps of a small Stage-I dVAE and of a small part-seg model,
    each run twice from the same seed on the card: every weight, BatchNorm
    statistic and Adam moment bit-equal (the DGCNN's and the 3-NN blend's
    gathers add their gradients in a fixed order)."""
    from act_tpu_torch.engine.runner_autoencoder import run_autoencoder_steps
    from act_tpu_torch.engine.runner_segmentation import build_seg_state
    from act_tpu_torch.engine.train_state import seg_step, step_rngs
    cfg = ConfigDict(dict(
        optimizer=dict(type="AdamW", kwargs=dict(lr=5e-4, weight_decay=5e-4)),
        scheduler=dict(type="CosLR", kwargs=dict(epochs=300, initial_epochs=10)),
        dataset=dict(train=dict(others=dict(npoints=256))), total_bs=4, grad_norm_clip=10,
        temp=dict(start=1, target=0.0625, ntime=100000),
        kldweight=dict(start=0, target=0.1, ntime=100000),
        model=dict(NAME="ACTPromptedDiscreteVAEwithVIT", group_size=8, num_group=16,
                   encoder_dims=32, num_tokens=64, tokens_dims=32, decoder_dims=32,
                   visual_embed_dim=48, visual_embed_depth=2, visual_embed_heads=4,
                   num_prompt_token=4, use_deep_prompt=True, freeze_visual_embed=True)))

    def state(model, opt):
        return ([t.detach().clone() for t in model.state_dict().values()]
                + [v.clone() for st in opt.state.values() for v in st.values()
                   if torch.is_tensor(v)])

    def stage1():
        run = run_autoencoder_steps(cfg, 2, device=cuda, start_itr=60000)
        return state(run.model, run.optimizer)

    def partseg():
        st = build_seg_state("partseg", 10, num_group=16, dtype="f32", device=cuda)
        pts = cloud(97, 4, 512, 3, device=cuda)
        seg = torch.randint(0, 50, (4, 512), generator=torch.Generator().manual_seed(2))
        oh = torch.eye(16)[[0, 3, 7, 15]]
        for i in range(2):
            seg_step(st.model, st.optimizer, st.schedule, pts, seg.to(cuda), i,
                     step_rngs(0, i, cuda), oh.to(cuda))
        return state(st.model, st.optimizer)
    for fn in (stage1, partseg):
        a, b = fn(), fn()
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)), fn.__name__
