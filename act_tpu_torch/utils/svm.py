"""A linear SVM probe without sklearn: the problem that sklearn's default
``LinearSVC()`` solves, solved by Newton's method in the primal.

For each class c (one against the rest, y = +1 for c and -1 otherwise) it
minimises ``1/2 |[w, b]|^2 + C sum_i max(0, 1 - y_i (w . x_i + b))^2`` with
C = 1 and the intercept regularised like a weight (liblinear appends a
constant feature, ``intercept_scaling = 1``). The objective is strictly
convex, so every solver that converges reaches the same [w, b]. The
generalised Hessian of a class is ``I + 2C X_A^T X_A`` over its margin
violators A: one (D+1)^2 Cholesky solve a class and iteration, all classes
at once, in float64 on the features' device, with an Armijo backtracking
line search. It stops when every class's gradient norm is at most ``tol``
of its norm at [w, b] = 0, or after ``max_iter`` iterations. A prediction is
the first argmax of the decision values, as in sklearn.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

ARMIJO = 0.01  # sufficient decrease of the line search
HALVINGS = 30  # most step halvings a line search tries


class LinearSVC:
    def __init__(self, C: float = 1.0, tol: float = 1e-6, max_iter: int = 50):
        self.C, self.tol, self.max_iter = float(C), float(tol), int(max_iter)
        self.n_iter_ = 0
        self.rel_grad_ = float("nan")

    @staticmethod
    def _augment(x, device) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)
        return torch.cat([x, torch.ones(x.shape[0], 1, dtype=x.dtype, device=device)], 1)

    def _objective(self, W: torch.Tensor, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        hinge = (1.0 - Y * (W @ X.T)).clamp_min(0.0)
        return 0.5 * (W * W).sum(1) + self.C * (hinge * hinge).sum(1)

    def _gradient(self, W: torch.Tensor, X: torch.Tensor, Y: torch.Tensor):
        Z = W @ X.T
        active = ((1.0 - Y * Z) > 0).to(W.dtype)
        return W + 2.0 * self.C * ((active * (Z - Y)) @ X), active

    def fit(self, x, y, device: Optional[torch.device] = None) -> "LinearSVC":
        """Fit on features ``x`` (n, D) and labels ``y`` (n,)."""
        y = np.asarray(y).reshape(-1)
        self.classes_ = np.unique(y)
        X = self._augment(x, device)
        labels = torch.as_tensor(np.searchsorted(self.classes_, y), device=X.device)
        K = len(self.classes_)
        Y = torch.where(labels[None] == torch.arange(K, device=X.device)[:, None], 1.0, -1.0
                        ).to(torch.float64)
        W = torch.zeros(K, X.shape[1], dtype=torch.float64, device=X.device)
        g0 = self._gradient(W, X, Y)[0].norm(dim=1).clamp_min(1e-300)
        eye = torch.eye(X.shape[1], dtype=torch.float64, device=X.device)
        for it in range(self.max_iter + 1):
            g, active = self._gradient(W, X, Y)
            rel = g.norm(dim=1) / g0
            self.n_iter_, self.rel_grad_ = it, float(rel.max())
            if self.rel_grad_ <= self.tol or it == self.max_iter:
                break
            H = torch.stack([eye + 2.0 * self.C * (X.T @ (active[k, :, None] * X))
                             for k in range(K)])
            d = -torch.cholesky_solve(g[..., None], torch.linalg.cholesky(H))[..., 0]
            f, slope = self._objective(W, X, Y), (g * d).sum(1)
            step = torch.ones(K, dtype=torch.float64, device=X.device)
            for _ in range(HALVINGS):
                short = self._objective(W + step[:, None] * d, X, Y) > f + ARMIJO * step * slope
                if not bool(short.any()):
                    break
                step = torch.where(short, 0.5 * step, step)
            W = W + step[:, None] * d
        self.coef_, self.intercept_ = W[:, :-1], W[:, -1]
        return self

    def decision_function(self, x) -> torch.Tensor:
        X = self._augment(x, self.coef_.device)
        return X[:, :-1] @ self.coef_.T + self.intercept_

    def predict(self, x) -> np.ndarray:
        return self.classes_[self.decision_function(x).argmax(1).cpu().numpy()]
