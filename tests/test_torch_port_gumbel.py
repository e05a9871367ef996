"""The port's hard Gumbel sample held against the JAX package on the CPU.

``gumbel_argmax_ref`` (the plain version of ``csrc/gumbel.cu`` and the CPU
path of ``ops.gumbel_argmax``) draws its noise from the counter hash of the
JAX kernel's interpret path, so for the same seed words its ids equal
``gumbel_argmax_pallas`` run through the Pallas interpreter.

Tolerance: ids equal, except on rows whose best two perturbed values lie
within 4 f32 ulp of each other, where XLA's and torch's CPU logs may round
apart; such rows are counted and may be at most 1 % of all rows.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from act_tpu.ops.sampling import gumbel_argmax_pallas

from act_tpu_torch import ops
from act_tpu_torch.ops import _backend, sampling

from tests.test_torch_port_ops import interpret  # noqa: F401 (a fixture)

SEED_WORDS = np.array([123456789, 2 ** 32 - 5], np.uint32)  # the second wraps negative


def seed_tensor(words=SEED_WORDS) -> torch.Tensor:
    """JAX's seed: the raw key words cast to int32 (``sampling.py:116``)."""
    return torch.from_numpy(np.asarray(words, np.uint32).view(np.int32).copy())


def near_tie_rows(logits: torch.Tensor, seed: torch.Tensor) -> np.ndarray:
    top2 = torch.topk(ops.gumbel_perturbed_ref(logits, seed), 2, dim=-1).values.numpy()
    return (top2[:, 0] - top2[:, 1]) <= 4 * np.spacing(np.abs(top2[:, 0]))


@pytest.mark.pallas
@pytest.mark.parametrize("shape", [(32, 64), (37, 200), (300, 8192)])
def test_ids_match_pallas_interpret(rng, interpret, shape):
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(gumbel_argmax_pallas(jnp.asarray(x), jnp.asarray(SEED_WORDS)))
    got = ops.gumbel_argmax(torch.from_numpy(x), seed_tensor())
    assert got.dtype == torch.int32 and tuple(got.shape) == shape[:1]
    differ = got.numpy() != want
    ties = near_tie_rows(torch.from_numpy(x), seed_tensor())
    assert not (differ & ~ties).any(), np.flatnonzero(differ & ~ties)
    assert differ.sum() <= 0.01 * shape[0]


@pytest.mark.pallas
def test_bf16_logits_match_pallas_interpret(rng, interpret):
    x = rng.normal(size=(3, 5, 300)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(gumbel_argmax_pallas(xb, jnp.asarray(SEED_WORDS)))
    got = ops.gumbel_argmax(torch.from_numpy(x).bfloat16(), seed_tensor())
    assert tuple(got.shape) == (3, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_deterministic_per_seed(rng):
    x = torch.from_numpy(rng.normal(size=(64, 500)).astype(np.float32))
    a = ops.gumbel_argmax(x, seed_tensor())
    assert torch.equal(a, ops.gumbel_argmax(x, seed_tensor()))
    b = ops.gumbel_argmax(x, seed_tensor([1, 2]))
    assert (a != b).float().mean() > 0.5


def test_ragged_width_equals_padding_with_minus_inf(rng):
    """The noise of a lane depends on the lane, the row and the chunk, and the
    chunk on V rounded up to 128: lanes past V padded with -inf change no id."""
    x = torch.from_numpy(rng.normal(size=(40, 200)).astype(np.float32))
    ids = ops.gumbel_argmax(x, seed_tensor())
    padded = torch.cat([x, torch.full((40, 56), float("-inf"))], dim=1)
    assert torch.equal(ids, ops.gumbel_argmax(padded, seed_tensor()))
    assert int(ids.max()) < 200


def test_chunk_formula_matches_jax():
    """Rows per chunk of the JAX grid, which the hash counts within."""
    assert ops.reference.gumbel_chunk(8192, 8192) == 128
    assert ops.reference.gumbel_chunk(5, 8192) == 8
    assert ops.reference.gumbel_chunk(20000, 16) == 256
    assert ops.reference.gumbel_chunk(300, 200) == 256


def test_pick_distribution(rng):
    """What the hash's noise gives, held as measured.

    Each lane's uniform draw is uniform on its own, and over 8192 equal
    logits the picks of 4096 rows spread evenly (512-lane buckets, chi-square p > 1e-3).
    But neighbouring lanes' draws are anti-correlated (about -0.4): the
    lane enters the hash as ``lane * 40503`` and three xorshift rounds do not
    decorrelate it. So over 20 000 rows of fixed 16-way logits the picks are
    NOT distributed as softmax(logits) by a chi-square test at p > 1e-3 (p
    about 1e-64); they stay within a total-variation distance of 0.1 of it
    (about 0.05 measured). A fault of the JAX package's interpret-path noise,
    which the port reproduces value for value (ROADMAP section 3)."""
    from scipy.stats import chi2
    u = torch.exp(-torch.exp(-ops.gumbel_perturbed_ref(torch.zeros(20000, 16),
                                                       seed_tensor([7, 11])))).numpy()
    assert abs(u.mean() - 0.5) < 0.005 and abs(u.var() - 1 / 12) < 0.002
    assert np.corrcoef(u[:, 0], u[:, 1])[0, 1] < -0.3
    ids = ops.gumbel_argmax(torch.zeros(4096, 8192, dtype=torch.bfloat16), seed_tensor([7, 11]))
    buckets = np.bincount(ids.numpy() // 512, minlength=16)
    assert chi2.sf(float(((buckets - 256.0) ** 2 / 256.0).sum()), df=15) > 1e-3

    logits = rng.normal(size=16).astype(np.float32)
    x = torch.from_numpy(np.tile(logits, (20000, 1)))
    counts = np.bincount(ops.gumbel_argmax(x, seed_tensor([7, 11])).numpy(), minlength=16)
    p = np.exp(logits - logits.max())
    p = p / p.sum()
    stat = float(((counts - 20000 * p) ** 2 / (20000 * p)).sum())
    assert chi2.sf(stat, df=15) < 1e-3  # the fault above
    assert 0.5 * np.abs(counts / 20000 - p).sum() < 0.1


def test_wrapper_validates_arguments():
    x = torch.zeros(4, 10)
    with pytest.raises(ValueError, match="seed"):
        ops.gumbel_argmax(x, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="seed"):
        ops.gumbel_argmax(x, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="V >= 1"):
        ops.gumbel_argmax(torch.zeros(4, 0), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.gumbel_argmax(torch.empty(4, 10, device="meta"),
                          torch.empty(2, dtype=torch.int32, device="meta"))


def test_draw_seed_and_cpu_path_launch_nothing():
    g = torch.Generator().manual_seed(0)
    seed = ops.draw_seed(g)
    assert seed.dtype == torch.int32 and seed.shape == (2,)
    assert not torch.equal(seed, ops.draw_seed(g))
    _backend.reset_launches()
    ops.gumbel_argmax(torch.zeros(3, 8), seed)
    assert _backend.LAUNCHES["gumbel_argmax"] == 0


# -- the kernel's screen: its launch geometry and a plain model of its rule --

@pytest.mark.parametrize("rows,V", [(8192, 8192), (1, 8192), (300, 1000), (37, 1001),
                                    (5, 1), (20000, 16), (3, 100000), (100000, 64),
                                    (512, 8192), (513, 8192), (8192, 1000)])
@pytest.mark.parametrize("sms", [132, 114, 1])
def test_launch_geometry_contract(rows, V, sms):
    """k within the kernel's range, the table within a block's default shared
    memory; no more blocks than stay resident; the persistent walk (a warp a
    row, rows blockIdx * 8 + warp, then the next blocks * 8) covers every row
    once."""
    k, blocks = sampling.launch_geometry(rows, V, sms)
    assert sampling.MIN_BITS <= k <= sampling.MAX_BITS
    assert sampling.table_bytes(k) <= sampling.SHARED_LIMIT
    assert 1 <= blocks <= sms * sampling.BLOCKS_PER_SM
    assert blocks <= -(-rows // sampling.WARPS)
    w = sampling.WARPS
    walked = np.concatenate([np.arange(b * w + g, rows, blocks * w)
                             for b in range(blocks) for g in range(w)])
    np.testing.assert_array_equal(np.sort(walked), np.arange(rows))


def test_launch_geometry_at_the_path_shapes():
    """The Stage-II shape fills the card's 528 resident blocks; one row takes
    one block; every k the kernel takes fits a block's shared memory."""
    assert sampling.launch_geometry(8192, 8192, 132) == (8, 528)
    assert sampling.launch_geometry(1, 8192, 132) == (8, 1)
    assert sampling.launch_geometry(1024, 8192, 132) == (8, 128)
    assert sampling.table_bytes(sampling.MAX_BITS) <= sampling.SHARED_LIMIT


def test_model_hash_is_the_plain_versions(rng):
    x = torch.from_numpy(rng.normal(size=(40, 777)).astype(np.float32))
    bits = sampling.hash_bits(40, 777, seed_tensor(), "cpu")
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 31
    torch.testing.assert_close(x + sampling.noise_of_bits(bits),
                               ops.gumbel_perturbed_ref(x, seed_tensor()), rtol=0, atol=0)


@pytest.mark.parametrize("k", [6, 8, 10])
def test_bucket_table_brackets_the_noise(k):
    """Entry 0 bounds the bits below the cut, entries 1 to 2^k the top buckets
    and the rest the uniform ones, each ordered and bracketing its bits'
    noise: 2^22 random bits and the ends of the range and of the cut lie
    within both of their entries (with the CPU's log; the card's is checked
    over all 2^31 bits by the GPU tests); only the two last buckets reach
    +inf (their lanes whose u rounds to 1)."""
    glo, ghi = sampling.bucket_table(k)
    n, b0 = 1 << k, sampling.B0
    assert glo.shape == ghi.shape == (2 * n + 1,)
    assert bool((glo <= ghi).all())
    for part in (glo[:n + 1], ghi[:n + 1]), (glo[n + 1:], ghi[n + 1:]):
        assert bool((part[1][:-1] <= part[0][1:]).all())
    assert torch.isposinf(ghi).nonzero().flatten().tolist() == [n, 2 * n]
    g = torch.Generator().manual_seed(k)
    bits = torch.cat([torch.randint(0, 2 ** 31, (1 << 22,), generator=g, dtype=torch.int64),
                      torch.arange(2 ** 16), 2 ** 31 - 1 - torch.arange(2 ** 16),
                      b0 - 2 ** 15 + torch.arange(2 ** 16)])
    f = sampling.noise_of_bits(bits)
    top, uni = sampling.buckets(bits, k)
    for b in (top, uni):
        assert bool((glo[b] <= f).all()) and bool((f <= ghi[b]).all())
    assert int(top.max()) == n and int(uni.min()) == n + 1 and int(uni.max()) == 2 * n
    assert torch.equal((top > 0), bits >= b0)


@pytest.mark.parametrize("k", [8, 6, 10])
@pytest.mark.parametrize("rows,V,dtype", [(256, 8192, torch.bfloat16),
                                          (64, 10000, torch.float32),
                                          (300, 1000, torch.bfloat16)])
def test_screen_model_equals_plain_version(k, rows, V, dtype):
    """The kernel's rule (prune a lane whose upper bound is below the row's
    largest lower bound, then the exact argmax of the rest) gives the plain
    version's ids on random rows and on the constructed exact and near ties,
    NaN, +inf and all-zero rows of ``sampling.gumbel_cases``; at the path's
    k and V = 8192 a handful of lanes a row survive."""
    x, seed, cases = sampling.gumbel_cases(rows, V, dtype, "cpu")
    want = ops.gumbel_argmax_ref(x, seed)
    ids, live = sampling.screen_ref(x, sampling.hash_bits(rows, V, seed, "cpu"), k)
    assert torch.equal(ids, want)
    assert sampling.check_gumbel_cases(ids, want, cases) == []
    assert {"tie, one warp", "NaN logit", "+inf logit", "all-zero row"} <= set(cases)
    assert int(live.min()) >= 1
    if k == sampling.BUCKET_BITS and V == 8192:
        assert float(live.float().median()) <= 4


@pytest.mark.parametrize("k", [8, 6, 10])
def test_screen_model_special_rows(k):
    """Rows of zeros, -inf, NaN and +inf with hand-set bits: a u = 1 lane
    (bits 2^31 - 1, +inf noise) wins its row; -inf on it gives NaN, which
    wins; a tie at +inf goes to the first index; an all -inf row picks 0;
    two logits of 1e30 absorb their noise and tie, the first index wins."""
    v = 64
    bits = torch.from_numpy(np.random.default_rng(k).integers(0, 2 ** 30, (6, v)))
    x = torch.zeros(6, v)
    bits[0, 9] = bits[1, 9] = bits[2, 40] = 2 ** 31 - 1
    x[1, 9] = float("-inf")
    x[2, 7] = float("inf")
    x[3, 20] = float("nan")
    x[4] = float("-inf")
    x[5, 30] = x[5, 31] = 1e30
    ids, _ = sampling.screen_ref(x, bits, k)
    exact = torch.argmax(x + sampling.noise_of_bits(bits), dim=-1).to(torch.int32)
    assert torch.equal(ids, exact)
    assert ids.tolist() == [9, 9, 7, 20, 0, 30]
