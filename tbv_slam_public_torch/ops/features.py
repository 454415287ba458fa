"""CFEAR oriented-surface-point features.

Port of ``tbv_slam_public_tpu.ops.features``: voxel binning (here an
``index_add_`` scatter instead of the reference's one-hot contractions), the
top-C occupied voxels (stable descending sort, lower voxel id first on equal
counts as ``lax.top_k``), masked radius statistics in coordinates centred on
each voxel centroid, and the closed-form 2x2 eigen gates.

The float32 arithmetic is rounded as the reference's compiled CPU program
rounds it (read from its optimized HLO and machine code): the radius gate's
two-term sums, the weight sum (a tree of in-order windows of 32 points), the
weighted mean and second moment (a dot loop that adds one point at a time,
in point order, by fused multiply-add), and the covariance diagonal, the
discriminant and the eigenvector norms inside the eigen gates (each a*b + c
with a single rounding).  Steps 3-4 (each cell's
statistics) are one ``cell_stats`` launch on the card
(``kernels/cells.py``, ``csrc/cells.cu``), whose plain version is
:func:`_cell_stats_reference`.  What is left is written down in ROADMAP.md,
section 3: the voxel sums' order.
"""
from __future__ import annotations

import torch

from ..core.config import FeatureConfig
from ..core.device import constant, deterministic
from ..core.refmath import mul_ftz, tree_sum
from ..core.types import Cells, PointCloud
from ..kernels import cells as cells_kernel
from ..kernels import refmath
from ..kernels.cells import cell_stats
from ..kernels.refmath import ftz


def eigh2x2(cov: torch.Tensor):
    """Closed-form eigendecomposition of symmetric 2x2 matrices.

    Returns (lmin, lmax, vmin) with vmin the unit eigenvector of lmin.  The
    discriminant 0.25 (a - c)^2 + b^2 and the squared norms of the two
    candidate eigenvectors are each one fused multiply-add, as the
    reference's compiled program computes them.  The two square roots are
    torch's (the reference's are the IEEE root, ``refmath.sqrt``: with it,
    trajectories of ``tests/test_torch_odometry_variants.py`` move past
    their tolerances, ROADMAP.md section 3 item 2); on the card torch's
    root is the IEEE one, which ``csrc/cells.cu`` computes.  Subnormal
    operands and every subnormal result are flushed (``ftz``), as the
    reference's threads flush them (DAZ and FTZ)."""
    cov = ftz(cov)
    a, b, c = cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]
    half_tr = ftz(0.5 * ftz(a + c))
    d = ftz(a - c)
    disc = torch.sqrt(torch.clamp(refmath.fma(
        ftz(d * d), torch.full_like(d, 0.25), ftz(b * b)), min=0.0))
    lmin = ftz(half_tr - disc)
    lmax = ftz(half_tr + disc)
    v1 = torch.stack([b, ftz(lmin - a)], -1)
    v2 = torch.stack([ftz(lmin - c), b], -1)
    n1 = _sqnorm(v1)
    n2 = _sqnorm(v2)
    v = torch.where((n1 > n2)[..., None], v1, v2)
    e0 = constant((1.0, 0.0), cov.dtype, cov.device)
    e1 = constant((0.0, 1.0), cov.dtype, cov.device)
    axis = torch.where((a <= c)[..., None], e0, e1)
    norm = torch.sqrt(torch.maximum(n1, n2))
    v = torch.where((norm > 1e-20)[..., None],
                    ftz(v / torch.clamp(norm, min=1e-20)[..., None]), axis)
    return lmin, lmax, v


def _sqnorm(v: torch.Tensor) -> torch.Tensor:
    """v0^2 + v1^2 of [..., 2] as fma(v1, v1, v0 v0), the product and the
    sum flushed."""
    return refmath.fma(v[..., 1], v[..., 1], ftz(v[..., 0] * v[..., 0]))


def _dot_in_order(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[:, k] * b[:, k] of [C, K, W] operands, added one k at a time
    from zero, each step a fused multiply-add: the reference's compiled dot
    loop over the points, here over each cell's neighbours in point order
    (the other points' terms are exact zeros)."""
    acc = torch.zeros(a.shape[:1] + a.shape[2:], dtype=a.dtype,
                      device=a.device)
    for k in range(a.shape[1]):
        acc = refmath.fma(a[:, k], b[:, k], acc)
    return acc


def _gate_sqdist(c: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[C, P] squared distances in the reference's |c|^2 + |p|^2 - 2 c.p
    form, rounded as its compiled program rounds them (each two-term sum a
    fused multiply-add).  At |p| ~ 70 m the form carries ~1e-3 m^2 of
    cancellation error, so any other rounding moves points across the
    radius gate and changes the cells."""
    c0, c1, p0, p1 = c[:, 0:1], c[:, 1:2], p[None, :, 0], p[None, :, 1]
    cc = refmath.fma(c1, c1, c0 * c0)
    pp = refmath.fma(p1, p1, p0 * p0)
    dot = refmath.fma(c1, p1, c0 * p0)
    return (cc + pp) - 2.0 * dot


def compute_cells(cloud: PointCloud, cfg: FeatureConfig,
                  origin=(0.0, 0.0)) -> Cells:
    """Point cloud [P] -> CFEAR cells [cell_capacity]: the voxel binning
    and top-C selection (:func:`select_cells`), then the cells' statistics,
    one ``cell_stats`` launch on the card (``kernels/cells.py``)."""
    centroid, occupied = select_cells(cloud, cfg)
    return Cells(*cell_stats(cloud.xy, cloud.intensity, cloud.mask, centroid,
                             occupied, cfg, origin))


def select_cells(cloud: PointCloud, cfg: FeatureConfig):
    """Steps 1-2 of ``compute_cells``: (centroid [C, 2], occupied [C]) of
    the cell_capacity most occupied voxels."""
    xy, mask = cloud.xy, cloud.mask
    dev, dt = xy.device, xy.dtype
    leaf = cfg.resolution / cfg.downsample_factor
    g = int(2 * cfg.grid_extent / leaf) + 2

    # 1. voxel binning
    ij = torch.clamp(torch.floor(xy / leaf).long() + g // 2, 0, g - 1)
    lin = ij[:, 0] * g + ij[:, 1]
    fmask = mask.to(dt)
    counts = torch.zeros(g * g, dtype=dt, device=dev).index_add_(0, lin, fmask)
    with deterministic():  # float sums in index order on the card too
        sums = torch.zeros((g * g, 2), dtype=dt, device=dev).index_add_(
            0, lin, xy * fmask[:, None])

    # 2. top-C occupied voxels
    occ = torch.where(counts > 0, counts, torch.full_like(counts, -1.0))
    sel = torch.sort(occ, descending=True, stable=True)[1][:cfg.cell_capacity]
    sel_count = counts[sel]
    sel_occupied = sel_count > 0
    centroid = sums[sel] / torch.clamp(sel_count, min=1.0)[:, None]
    return centroid, sel_occupied


def _cell_stats_reference(xy: torch.Tensor, intensity: torch.Tensor,
                          mask: torch.Tensor, centroid: torch.Tensor,
                          sel_occupied: torch.Tensor, cfg: FeatureConfig,
                          origin=(0.0, 0.0)):
    """Steps 3-4 of ``compute_cells``, the plain version of the
    ``cell_stats`` kernel: each cell's neighbours within the radius of its
    centroid, their intensity weights, weighted mean and covariance, the
    eigen gates, normal and planarity.  Returns Cells' fields (mean, cov,
    normal, nsamples, planarity, avg_intensity, valid), zero where
    invalid.  Runs on CPU tensors, or on CUDA tensors inside
    ``kernels.cells.plain_on_card`` only."""
    if xy.device.type != "cpu" and not cells_kernel.plain_on_card_enabled():
        raise RuntimeError("the plain cell_stats runs on the CPU; on the "
                           "card it runs inside kernels.cells.plain_on_card "
                           "only")
    dev, dt = xy.device, xy.dtype
    radius = cfg.resolution
    # 3. masked neighbourhood stats, centred on the voxel centroid
    nbr = (_gate_sqdist(centroid, xy) <= radius * radius) & mask[None, :] \
        & sel_occupied[:, None]
    nbr_count = nbr.sum(1)
    if cfg.weight_intensity:
        w = torch.clamp(intensity - cfg.intensity_floor, min=0.0)
    else:
        w = torch.ones_like(intensity)
    wm = torch.where(nbr, w[None, :], torch.zeros((), dtype=dt, device=dev))
    w_sum = tree_sum(wm)
    w_norm = wm / torch.clamp(w_sum, min=1e-12)[:, None]
    # each cell's neighbours in point order ([C, K], K the most any cell has;
    # the slots past a cell's count hold weight 0)
    k = int(nbr_count.max()) if nbr.shape[0] else 0
    order = torch.sort(nbr.to(torch.uint8), dim=1, descending=True,
                       stable=True)[1][:, :k]
    wk = torch.gather(w_norm, 1, order)
    q = xy[order] - centroid[:, None, :]  # [C, K, 2]
    wq = wk[..., None] * q
    # mu = sum w q and qq = sum (w q_i) q_j, in one loop over k
    acc = _dot_in_order(torch.stack([wk, wk, wq[..., 0], wq[..., 0],
                                     wq[..., 1], wq[..., 1]], -1),
                        q.repeat(1, 1, 3))
    mu_local, qq = acc[:, :2], acc[:, 2:].reshape(-1, 2, 2)
    # from here on every subnormal result is flushed (ftz), as the
    # reference's threads flush it
    cov = ftz(qq - mul_ftz(mu_local[:, :, None], mu_local[:, None, :]))
    cov = ftz(0.5 * ftz(cov + cov.transpose(-1, -2)))
    mean = ftz(centroid + mu_local)

    # 4. eigen-based normal + gates, on the covariance as the reference's
    # gate computations form it: its diagonal fma(-mu_i, mu_i, qq_ii) (the
    # product has one use there), the off-diagonal as above
    diag = refmath.fma(-mu_local, mu_local,
                       torch.diagonal(qq, dim1=-2, dim2=-1))
    cov_g = torch.stack([torch.stack([diag[:, 0], cov[:, 0, 1]], -1),
                         torch.stack([cov[:, 1, 0], diag[:, 1]], -1)], -2)
    lmin, lmax, normal = eigh2x2(cov_g)
    cond = ftz(torch.abs(lmax / torch.where(torch.abs(lmin) > 1e-20, lmin,
                                            torch.full_like(lmin, 1e-20))))
    det = mul_ftz(lmax, lmin)
    cov_ok = (cond <= cfg.max_cond) & (det > cfg.min_det) & (lmin > 0) & \
        (lmax > 0)
    planarity = refmath.log1p(ftz(cond / 2.0))
    org = constant((float(origin[0]), float(origin[1])), dt, dev)
    flip = refmath.fma(normal[:, 1], ftz(org[1] - mean[:, 1]), mul_ftz(
        normal[:, 0], ftz(org[0] - mean[:, 0]))) < 0
    normal = torch.where(flip[:, None], -normal, normal)

    valid = sel_occupied & (nbr_count >= cfg.min_neighbors) & cov_ok & \
        (w_sum > 1e-9)
    avg_intensity = ftz(w_sum / torch.clamp(nbr_count, min=1))

    def z(x):
        m = valid.reshape(valid.shape + (1,) * (x.ndim - 1))
        return torch.where(m, x, torch.zeros((), dtype=x.dtype, device=dev))

    return (z(mean), z(cov), z(normal), z(nbr_count.to(dt)), z(planarity),
            z(avg_intensity), valid)


def transform_cells(cells: Cells, pose: torch.Tensor) -> Cells:
    """Rigid transform of a feature set (cell::TransformCopy)."""
    s, c = refmath.sincos(pose[..., 2])
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    mean = cells.mean @ rot.T + pose[..., :2]
    normal = cells.normal @ rot.T
    cov = torch.einsum("ab,cbd,ed->cae", rot, cells.cov, rot)
    return cells.replace(mean=mean, normal=normal, cov=cov)
