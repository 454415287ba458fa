"""The registration kernel's LM schedule on the CPU: a run of rejections
evaluated in one pass (``csrc/lm_solve.cu``'s ``lm_solve``), modelled over
the plain ``_cost_grad_hess`` and held bit for bit to the serial
``_lm_solve_reference``.  The kernel itself is held to the plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2b)."""
import math

import numpy as np
import pytest
import torch

from tbv_slam_public_torch.core.types import Cells
from tbv_slam_public_torch.kernels import refmath
from tbv_slam_public_torch.kernels.checks import lm_problem
from tbv_slam_public_torch.ops import registration as treg

# one intra-op thread per test worker (the suite runs several on one host)
torch.set_num_threads(1)

F32 = np.float32


#: where set, a pose farther than ``tau`` from ``center`` gets a NaN cost
_CAP: dict = {}


def _nan_at(theta: torch.Tensor) -> torch.Tensor:
    """Rows whose pose's angle has these bits get a NaN cost (in the plain
    solve and the model alike): a candidate that the card would compute as
    NaN, placed by its bits, so both orders of evaluation meet it; and,
    under ``_CAP``, a pose too far from its center (a long step rejected)."""
    nan = ((theta[:, 2].view(torch.int32) >> 3) % 8) == 5
    if _CAP:
        d = (theta.double() - _CAP["center"].double()).norm(dim=-1)
        nan = nan | (d > _CAP["tau"])
    return nan


def _cap_at_slot(theta0, src, assoc, lam0, slot, kw):
    """A cap on the step's length between the steps at lambda_{slot-1} and
    lambda_slot from theta0, so that the first pass's candidates before
    ``slot`` are rejected and the one at ``slot`` is evaluated."""
    _, g, h = treg._cost_grad_hess(theta0, src, assoc, **kw)
    lam, lens = torch.full((1,), lam0), []
    for _ in range(slot + 1):
        damp = torch.diag_embed(refmath.fma(lam[:, None], torch.diagonal(
            h, dim1=-2, dim2=-1), torch.full_like(g, 1e-12)))
        c = refmath.lm_update(theta0, h + damp, g, one_system=True)
        lens.append(float((c.double() - theta0.double()).norm()))
        lam = torch.clamp(lam * 4.0, max=1e6)
    return dict(center=theta0, tau=0.5 * (lens[-2] + lens[-1]))


def _with_nan(fn):
    def wrapped(theta, *a, **k):
        out = fn(theta, *a, **k)
        nan = torch.full_like(out[0] if isinstance(out, tuple) else out,
                              math.nan)
        if isinstance(out, tuple):
            return (torch.where(_nan_at(theta), nan, out[0]),) + out[1:]
        return torch.where(_nan_at(theta), nan, out)
    return wrapped


def batched_solve(theta0, src, assoc, *, k, max_iter, init_lambda,
                  one_system=False, events=None, lams=None, **kw):
    """``csrc/lm_solve.cu``'s ``lm_solve`` on one row (B = 1 tensors): a
    pass evaluates up to k candidates along the reject branch (lambda_j =
    min(4 lambda_{j-1}, 1e6) from the current lambda, each the serial
    loop's step; one candidate after an accepted step), the first accepted
    in order (cc < cur) is taken with its iteration and the rejections
    before it; the pass sums the first candidate's g and H and the others'
    costs, so a later one's acceptance takes a pass at it for its g and H.
    Returns (theta, cost, rel_dec, passes); ``events`` (a list) gets (pass
    size, accepted slot or None, any NaN cost), ``lams`` (a set) every
    lambda the serial loop reaches."""
    fma = refmath.fma
    cur, g, h = treg._cost_grad_hess(theta0, src, assoc, **kw)
    theta, passes, it, accepted = theta0, 1, 0, False
    lam = torch.full_like(cur, init_lambda)
    rd = torch.ones_like(cur)
    while it < max_iter:
        nb = min(1 if accepted else k, max_iter - it)
        steps = [lam]
        for _ in range(nb - 1):
            steps.append(torch.clamp(steps[-1] * 4.0, max=1e6))
        cands, costs = [], []
        for j, lj in enumerate(steps):
            damp = torch.diag_embed(fma(lj[:, None], torch.diagonal(
                h, dim1=-2, dim2=-1), torch.full_like(g, 1e-12)))
            c = refmath.lm_update(theta, h + damp, g, one_system=one_system)
            cands.append(c)
            costs.append(treg._cost_grad_hess(c, src, assoc, **kw) if j == 0
                         else (treg._cost_only(c, src, assoc, **kw),))
        passes += 1
        took = [j for j in range(nb) if bool(costs[j][0][0] < cur[0])]
        if events is not None:
            events.append((nb, took[0] if took else None,
                           any(bool(torch.isnan(x[0]).any()) for x in costs)))
        accepted = bool(took)
        if took:
            j = took[0]
            cc = costs[j][0]
            theta = cands[j]
            rd = (cur - cc) / torch.clamp(cur, min=1e-20)
            cur = cc
            lam = torch.clamp(steps[j] * 0.5, min=1e-9)
            it += j + 1
            if j == 0:
                g, h = costs[j][1:]
            else:  # the pass at the accepted candidate
                _, g, h = treg._cost_grad_hess(theta, src, assoc, **kw)
                passes += 1
        else:
            it += nb
            lam = torch.clamp(steps[-1] * 4.0, max=1e6)
        if lams is not None:  # after each iteration of the pass
            lams.update(float(x[0]) for x in steps[1:(took[0] + 1) if took
                                                    else nb] + [lam])
    return theta, cur, rd, passes


def _schedule_rows(rng, cost):
    """Rows of small LM problems (T = 2, C = 32) whose serial solve runs
    every pattern: accepts then only rejections, rejections every time (a
    start far off, a NaN weight), accepts after runs of rejections, lambda
    at 1e6 and at 1e-9, and one whose long steps the test rejects (``_CAP``)
    so that the first pass accepts at its last slot; each (theta0, src,
    assoc, loss, init_lambda, capped)."""
    rows = []
    for i, (loss, lam0, spread) in enumerate(
            [(1, 1e-4, 1.0), (1, 1e-4, 10.0), (1, 1e-9, 1.0),
             (4, 1e-4, 1.0), (4, 1e-9, 10.0), (4, 1e-4, 10.0),
             (0, 1e-9, 3.0), (2, 1e5, 1.0), (1, 1e-4, 0.3)]):
        theta0, src, tm, tn, w, m, si, _ = lm_problem(rng, 1, 2, 32, cost,
                                                      False)
        theta0 = theta0 + F32(spread) * (rng.normal(0, 0.3, theta0.shape)
                                         * F32([1, 1, 0.1])).astype(F32)
        if i == 7:  # a NaN weight where the mask holds: every cost NaN
            w[0, 0, np.argmax(m[0, 0])] = np.nan
        t = lambda x: None if x is None else torch.as_tensor(x)
        rows.append((t(theta0.astype(F32)), Cells(t(src), None, None, None,
                                                  None, None, None),
                     treg.Associations(t(tm), t(tn), t(w), t(m), t(si)),
                     loss, lam0, i == 8))
    return rows


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("max_iter", [10, 20, 7])
def test_batched_schedule_is_the_serial_solve(k, max_iter, monkeypatch):
    """The kernel's schedule (``batched_solve``: up to k candidates a pass
    along a run of rejections, the first accepted taken) gives the serial
    ``_lm_solve_reference``'s theta, cost and rel_dec bit for bit, in at
    most 1 + max_iter passes, on rows that accept then reject, reject every
    time, accept at a pass's last slot, meet a NaN candidate cost, and have
    lambda reach 1e6 and 1e-9 (each met at least once over the rows)."""
    monkeypatch.setattr(treg, "_cost_grad_hess",
                        _with_nan(treg._cost_grad_hess))
    monkeypatch.setattr(treg, "_cost_only", _with_nan(treg._cost_only))
    rng = np.random.default_rng(k * 100 + max_iter)
    events, lams, all_rejected = [], set(), 0
    for cost in ("P2L", "P2P", "P2D"):
        for theta0, src, assoc, loss, lam0, cap in _schedule_rows(rng,
                                                                  cost):
            kw = dict(cost=treg.cost_code(cost), loss=loss, delta=0.5)
            _CAP.clear()
            if cap:
                _CAP.update(_cap_at_slot(theta0, src, assoc, lam0,
                                         min(k, max_iter) - 1, kw))
            want = treg._lm_solve_reference(
                theta0, src, assoc, max_iter=max_iter, init_lambda=lam0,
                one_system=True, **kw)
            row = []
            *got, passes = batched_solve(
                theta0, src, assoc, k=k, max_iter=max_iter,
                init_lambda=lam0, one_system=True, events=row, lams=lams,
                **kw)
            for g, w in zip(got, want):
                assert torch.equal(g.view(torch.int32),
                                   w.view(torch.int32)), (cost, loss)
            assert passes <= 1 + max_iter
            events.extend(row)
            all_rejected += all(j is None for _, j, _ in row)
    _CAP.clear()
    full = min(k, max_iter)
    assert all_rejected > 0
    assert any(nb == full and j == full - 1 for nb, j, _ in events)
    assert any(nan for *_, nan in events)
    assert 1e6 in lams and float(F32(1e-9)) in lams
