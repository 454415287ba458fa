"""Logistic regression: penalised IRLS fit, inference, coefficient I/O.

Port of ``tbv_slam_public_tpu.ops.logistic``: sklearn's
LogisticRegression(class_weight="balanced", C=1) as a Newton/IRLS solve on
tensors; ``predict_linear`` is the reference's coef . x + intercept.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import refmath


class LogisticModel(NamedTuple):
    intercept: torch.Tensor  # []
    coef: torch.Tensor  # [D]

    def to(self, device) -> "LogisticModel":
        return LogisticModel(self.intercept.to(device), self.coef.to(device))


def predict_linear(model: LogisticModel, x: torch.Tensor) -> torch.Tensor:
    """Raw decision value coef . x + intercept for [..., D] inputs."""
    return x @ model.coef + model.intercept


def predict_proba(model: LogisticModel, x: torch.Tensor) -> torch.Tensor:
    return refmath.sigmoid(predict_linear(model, x))


def predict(model: LogisticModel, x: torch.Tensor) -> torch.Tensor:
    return predict_proba(model, x) > 0.5


def gradient(xt: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """xb^T r for xt = xb^T [D + 1, N], r [N]: the IRLS gradient's sum, in
    the order in which the reference's compiled loop adds its N terms
    (``core/refmath.py::loop_dot_shape``, read for every N the paths give
    it)."""
    return refmath.loop_dot(xt, r)


def solve(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """h^{-1} g for float32 h [K, K], g [K], K <= 7, rounded as the
    reference's ``jnp.linalg.solve``: LAPACK's sgetrf, g permuted by its
    pivots, BLAS's strsm on the unit lower and the upper factor, with the
    operation order of the library jaxlib calls
    (``core/refmath.py::lu_solve``; the refmath kernel op ``lu_solve`` on
    the card)."""
    return refmath.lu_solve(h, g)


def fit(x: torch.Tensor, y: torch.Tensor, sample_mask: torch.Tensor = None, *,
        c: float = 1.0, iterations: int = 50,
        balanced: bool = True) -> LogisticModel:
    """Penalised IRLS fit of sigma(w.x + b) for x [N, D], y [N] in {0, 1}.

    sklearn's objective: minimise sum_i s_i * logloss_i + 0.5/C * |w|^2 with
    the intercept unpenalised; "balanced" class weights are
    n_samples / (2 * n_class)."""
    n, d = x.shape
    dt, dev = x.dtype, x.device
    fm = torch.ones(n, dtype=dt, device=dev) if sample_mask is None \
        else sample_mask.to(dt)
    y = y.to(dt)
    if balanced:
        n_eff = fm.sum()
        n_pos = (fm * y).sum()
        w_pos = n_eff / (2.0 * torch.clamp(n_pos, min=1.0))
        w_neg = n_eff / (2.0 * torch.clamp(n_eff - n_pos, min=1.0))
        sw = torch.where(y > 0.5, w_pos, w_neg) * fm
    else:
        sw = fm
    xb = torch.cat([torch.ones((n, 1), dtype=dt, device=dev), x], 1)
    reg = torch.cat([torch.zeros(1, dtype=dt, device=dev),
                     torch.full((d,), 1.0 / c, dtype=dt, device=dev)])
    reg_diag = torch.diag(reg)
    eps_eye = 1e-8 * torch.eye(d + 1, dtype=dt, device=dev)
    w = torch.zeros(d + 1, dtype=dt, device=dev)
    xt = xb.T.contiguous()
    for _ in range(iterations):
        # rounded as the reference's program: xb @ w and the Hessian's
        # products one fused multiply-add a term in order (its emitted loop
        # and its matrix kernel at this shape), its sigmoid's exp, the
        # gradient's sum in its vectorised loop's order (``gradient``),
        # reg * w fused into the gradient's add, the ridge added in source
        # order, the solve by its LAPACK routines (``solve``)
        # subnormal results flushed as the reference's threads flush them:
        # ``dot``, ``loop_dot`` and ``lu_solve`` flush their operands (DAZ),
        # which covers sw (p - y), xb r, g and h; w is flushed here
        p = refmath.sigmoid(refmath.dot(xb, w[None])[:, 0])
        g = refmath.fma(reg, w, gradient(xt, sw * (p - y)))
        r = torch.clamp(sw * p * (1.0 - p), min=1e-8)
        h = (refmath.dot((xb * r[:, None]).T, xt) + reg_diag) + eps_eye
        # damped Newton keeps early iterations stable on separable data
        w = refmath.ftz(w - torch.clamp(solve(h, g), -10.0, 10.0))
    return LogisticModel(intercept=w[0], coef=w[1:])


def accuracy(model: LogisticModel, x, y, mask=None) -> torch.Tensor:
    ok = predict(model, x) == (y > 0.5)
    if mask is not None:
        return (ok & mask).sum() / torch.clamp(mask.sum(), min=1)
    return ok.float().mean()


def confusion(model: LogisticModel, x, y, mask=None):
    """(tp, fp, tn, fn) counts."""
    pred = predict(model, x)
    truth = y > 0.5
    if mask is None:
        mask = torch.ones_like(truth)
    return ((pred & truth & mask).sum(), (pred & ~truth & mask).sum(),
            (~pred & ~truth & mask).sum(), (~pred & truth & mask).sum())


def roc_curve(model: LogisticModel, x, y, mask=None, thresholds: int = 101):
    """(fpr, tpr) NumPy arrays over evenly spaced probability thresholds."""
    host = lambda t: t.detach().cpu().numpy() if torch.is_tensor(t) \
        else np.asarray(t)
    p = host(predict_proba(model, x))
    truth = host(y) > 0.5
    m = np.ones_like(truth) if mask is None else host(mask)
    pos = max(np.sum(truth & m), 1)
    neg = max(np.sum(~truth & m), 1)
    tpr, fpr = [], []
    for t in np.linspace(0, 1, thresholds):
        pred = (p >= t) & m
        tpr.append(np.sum(pred & truth) / pos)
        fpr.append(np.sum(pred & ~truth) / neg)
    return np.asarray(fpr), np.asarray(tpr)


def from_values(intercept: float, coef, device=None) -> LogisticModel:
    return LogisticModel(
        intercept=torch.tensor(float(intercept), dtype=torch.float32,
                               device=device),
        coef=torch.as_tensor(np.asarray(coef, np.float32), device=device))


def save_coefficients(model: LogisticModel, path: str) -> None:
    """CSV row: intercept, coef... (trained_*_classifier.txt format)."""
    vals = [float(model.intercept)] + [float(v) for v in
                                       model.coef.detach().cpu().tolist()]
    with open(path, "w") as f:
        f.write(",".join(f"{v:.6g}" for v in vals) + "\n")


def load_coefficients(path: str, device=None) -> LogisticModel:
    row = np.loadtxt(path, delimiter=",", ndmin=1)
    return from_values(row[0], row[1:], device=device)
