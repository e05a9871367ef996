"""t-SNE of feature vectors into the plane, on the tensors' device.

The counterpart of ``act_tpu/engine/runner_tsne.py:82-86`` ``_embed``, and so
of the scikit-learn ``TSNE(n_components=2, init="pca", metric="cosine",
perplexity=min(25, max(2, N // 4)))`` that it calls, with its defaults: early
exaggeration 12 for the first 250 iterations at momentum 0.5, then momentum
0.8 up to 1000 iterations, the learning rate ``max(N / 12 / 4, 50)``,
per-coordinate gains (+0.2 / x0.8, at least 0.01), the error checked every 50
iterations, a stop after 300 iterations without progress or at a gradient
norm of 1e-7, one degree of freedom.

P is built as scikit-learn's Barnes-Hut path builds it
(``sklearn/manifold/_t_sne.py`` ``_fit`` and ``_joint_probabilities_nn``):
the ``min(N - 1, int(3 * perplexity + 1))`` nearest neighbours of each row by
cosine distance, those distances squared (``_fit`` squares the neighbour
graph's distances for every metric), a binary search of each row's Gaussian
precision to the perplexity (``_utils._binary_search_perplexity``, in f64),
then ``P + P^T`` normalised to sum 1.

The gradient is exact: O(N^2) over one dense N x N f32 matrix (33 MB at
N = 2882), which is the limit of Barnes-Hut as its angle goes to 0, so the
function is scikit-learn's without the tree's approximation. It is written in
plain torch operations on the device of its input: it replaces scikit-learn's
Cython, not a TPU kernel, so it has no hand-written kernel. The PCA init takes
an exact eigendecomposition in place of scikit-learn's randomized solver and
``svd_flip``'s sign rule, so nothing is drawn at random: two runs on one
device give the same embedding.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

MACHINE_EPSILON = float(np.finfo(np.double).eps)
EARLY_EXAGGERATION = 12.0
EXPLORATION_ITER = 250
MAX_ITER = 1000
N_ITER_CHECK = 50
N_ITER_WITHOUT_PROGRESS = 300
MIN_GAIN = 0.01
MIN_GRAD_NORM = 1e-7
SEARCH_STEPS = 100
# scikit-learn's Cython keeps these two as C floats
SEARCH_EPS = float(np.float32(1e-8))
PERPLEXITY_TOLERANCE = float(np.float32(1e-5))


def default_perplexity(n: int) -> float:
    """``runner_tsne._embed``'s perplexity for ``n`` points."""
    return float(min(25, max(2, n // 4)))


def cosine_knn(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` nearest other rows of each row of ``x`` (N, D) by cosine
    distance ``clip(1 - cos, 0, 2)``, as scikit-learn's ``cosine_distances``
    computes it in ``x``'s dtype (rows of norm 0 stay 0, so they sit at
    distance 1): (distances (N, k), int64 indices (N, k)), ascending, ties
    to the smaller index."""
    norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    xn = x / torch.where(norm == 0, torch.ones_like(norm), norm)
    d = torch.clamp(1.0 - xn @ xn.T, 0.0, 2.0)
    d.fill_diagonal_(float("inf"))  # a row is not its own neighbour
    dist, idx = torch.sort(d, dim=1, stable=True)
    return dist[:, :k], idx[:, :k]


def binary_search_perplexity(sqd: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Conditional P (N, k) f64 of the neighbours' squared distances ``sqd``
    (N, k): each row's Gaussian precision ``beta`` found by the bisection of
    ``sklearn/manifold/_utils.pyx``, all rows at once, a row frozen at the
    step where its entropy is within 1e-5 of ``log(perplexity)``. A row whose
    search cannot reach the perplexity (equal distances) ends after 100
    steps with finite P, as there; a row whose weights all underflow gets
    P = 0, as there."""
    d = sqd.to(torch.float64)
    n = d.shape[0]
    target = math.log(float(np.float32(perplexity)))
    beta = torch.ones(n, 1, dtype=torch.float64, device=d.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    p = torch.zeros_like(d)
    done = torch.zeros(n, 1, dtype=torch.bool, device=d.device)
    for _ in range(SEARCH_STEPS):
        w = torch.exp(-d * beta)
        s = w.sum(dim=1, keepdim=True)
        s = torch.where(s == 0.0, torch.full_like(s, SEARCH_EPS), s)
        pw = w / s
        entropy = torch.log(s) + beta * (d * pw).sum(dim=1, keepdim=True)
        diff = entropy - target
        p = torch.where(done, p, pw)
        done = done | (diff.abs() <= PERPLEXITY_TOLERANCE)
        up = diff > 0.0  # too flat: sharpen
        lo = torch.where(~done & up, beta, lo)
        hi = torch.where(~done & ~up, beta, hi)
        beta = torch.where(done, beta, torch.where(
            up, torch.where(hi == math.inf, beta * 2.0, (beta + hi) / 2.0),
            torch.where(lo == -math.inf, beta / 2.0, (beta + lo) / 2.0)))
        if bool(done.all()):
            break
    return p


def joint_probabilities_nn(sqd: torch.Tensor, idx: torch.Tensor, perplexity: float
                           ) -> torch.Tensor:
    """Dense joint P (N, N) f64 of a neighbour graph (squared distances and
    indices (N, k)): the conditional P of :func:`binary_search_perplexity`
    scattered to its columns, ``P + P^T``, normalised to sum 1
    (``_joint_probabilities_nn``)."""
    n = sqd.shape[0]
    cond = binary_search_perplexity(sqd, perplexity)
    p = torch.zeros(n, n, dtype=torch.float64, device=sqd.device)
    p.scatter_(1, idx, cond)
    p = p + p.T
    return p / torch.clamp_min(p.sum(), MACHINE_EPSILON)


def kl_divergence(y: torch.Tensor, p: torch.Tensor, compute_error: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The KL divergence of P from the Student-t Q of the embedding ``y``
    (N, 2), one degree of freedom, and its exact gradient (N, 2)
    (``sklearn/manifold/_t_sne.py`` ``_kl_divergence``), in ``y``'s dtype.
    The error is NaN unless ``compute_error``."""
    dx = y[:, 0, None] - y[None, :, 0]
    dy = y[:, 1, None] - y[None, :, 1]
    w = 1.0 / (1.0 + (dx * dx + dy * dy))
    w.fill_diagonal_(0.0)
    q = torch.clamp_min(w / w.sum(), MACHINE_EPSILON)
    if compute_error:
        kl = (p * torch.log(torch.clamp_min(p, MACHINE_EPSILON) / q)).sum()
    else:
        kl = torch.full((), float("nan"), dtype=y.dtype, device=y.device)
    pqd = (p - q) * w
    grad = 4.0 * torch.stack([(pqd * dx).sum(dim=1), (pqd * dy).sum(dim=1)], dim=1)
    return kl, grad


def gradient_descent(y: torch.Tensor, p: torch.Tensor, it: int, max_iter: int,
                     momentum: float, learning_rate: float,
                     n_iter_without_progress: int = N_ITER_WITHOUT_PROGRESS,
                     min_grad_norm: float = MIN_GRAD_NORM
                     ) -> Tuple[torch.Tensor, float, int]:
    """Iterations ``it`` .. ``max_iter - 1`` of scikit-learn's
    ``_gradient_descent`` on :func:`kl_divergence` from ``y``: momentum and
    gains from rest, the error every ``N_ITER_CHECK`` iterations and at the
    last, a stop after ``n_iter_without_progress`` iterations without a
    better error or at a gained-gradient norm of ``min_grad_norm``. Returns
    (y, the last error, the last iteration)."""
    y = y.clone()
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % N_ITER_CHECK == 0
        last = i == max_iter - 1
        kl, grad = kl_divergence(y, p, compute_error=check or last)
        inc = update * grad < 0.0
        gains = torch.clamp_min(torch.where(inc, gains + 0.2, gains * 0.8), MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad
        y = y + update
        if check or last:  # read back only where scikit-learn computes it
            error = float(kl)
        if check:
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if float(torch.linalg.vector_norm(grad)) <= min_grad_norm:
                break
    return y, error, i


def pca_init(x: torch.Tensor, n_components: int = 2) -> torch.Tensor:
    """scikit-learn's ``init="pca"``: the projection of ``x`` (N, D) on its
    first ``n_components`` principal axes, each axis signed so that its
    largest-magnitude entry is positive (``svd_flip`` on the rows of Vt),
    in f32, scaled so that column 0 has standard deviation 1e-4. The axes
    come from an exact f64 eigendecomposition of the covariance. Inputs
    whose column 0 is constant keep the unscaled projection (scikit-learn
    divides by 0 there)."""
    xc = x.to(torch.float64)
    xc = xc - xc.mean(dim=0, keepdim=True)
    _, vecs = torch.linalg.eigh(xc.T @ xc)
    axes = vecs[:, -n_components:].flip(1).T  # (n_components, D), largest first
    pick = axes.abs().argmax(dim=1, keepdim=True)
    axes = axes * torch.sign(axes.gather(1, pick))
    y = (xc @ axes.T).to(torch.float32)
    std = torch.std(y[:, 0], correction=0)
    return y / std * 1e-4 if float(std) > 0 else y


@dataclass
class Embedding:
    """What :func:`embed` returns: the (N, 2) f32 embedding, the KL
    divergence of its last check, the last iteration, and the perplexity."""
    y: np.ndarray
    kl: float
    n_iter: int
    perplexity: float


def embed(feats, device="cuda") -> Embedding:
    """``runner_tsne._embed`` of ``feats`` (N, D), computed on ``device``
    (the card unless "cpu"): the cosine neighbour graph, P, the PCA init and
    both optimisation stages of :func:`gradient_descent` in f32."""
    from act_tpu_torch.ops import resolve_device

    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(feats, np.float32), device=dev)
    n = x.shape[0]
    if n < 2:
        raise ValueError(f"t-SNE needs at least 2 points, got {n}")
    perplexity = default_perplexity(n)
    if perplexity >= n:
        raise ValueError(f"perplexity ({perplexity}) must be less than n_samples ({n})")
    k = min(n - 1, int(3.0 * perplexity + 1))
    dist, idx = cosine_knn(x, k)
    p = joint_probabilities_nn(dist * dist, idx, perplexity).to(torch.float32)
    lr = max(n / EARLY_EXAGGERATION / 4, 50.0)
    y, _, it = gradient_descent(pca_init(x), p * EARLY_EXAGGERATION, 0, EXPLORATION_ITER,
                                0.5, lr, n_iter_without_progress=EXPLORATION_ITER)
    y, kl, it = gradient_descent(y, p, it + 1, MAX_ITER, 0.8, lr)
    return Embedding(y.cpu().numpy(), kl, it, perplexity)
