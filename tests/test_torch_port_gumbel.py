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
from act_tpu_torch.ops import _backend

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
