"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``cuda`` marker and skips where no card is
present.  The file imports nothing of JAX, so it also runs on a machine that
has none; ``tests/conftest.py`` does import JAX, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from tbv_slam_public_torch.kernels import coral_moments as tmoments

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

# CorAl moments: float32 sums taken in another order than the plain version
RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(seed, m, q, p, dev, frac=0.8, extent=30.0, packed=False):
    rng = np.random.default_rng(seed)

    def mask(n):
        if packed:  # live slots first, as the pipeline's clouds
            live = rng.uniform(0.8, 1.2, (m, 1)) * frac * n
            return np.arange(n)[None] < live
        return rng.uniform(size=(m, n)) < frac

    arrays = (rng.uniform(-extent, extent, (m, q, 2)).astype(np.float32),
              mask(q),
              rng.uniform(-extent, extent, (m, p, 2)).astype(np.float32),
              mask(p))
    return [torch.as_tensor(a, device=dev) for a in arrays]


def _assert_moments(got, want):
    # the radius gate rounds as the plain version does: counts are exact
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,q,p,frac", [
    (1, 50, 70, 0.8), (1, 128, 512, 0.8), (1, 200, 600, 0.8),
    (4, 4096, 4096, 0.8), (3, 300, 700, 0.0)])
def test_coral_kernel_matches_plain(cuda, m, q, p, frac):
    args = _inputs(0, m, q, p, cuda, frac)
    _assert_moments(tmoments.neighbor_moments(*args, 1.0),
                    tmoments.neighbor_moments_reference(*args, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("m,q,p,frac,packed", [
    (2, 513, 1025, 0.8, False),  # one past a query block, one past a tile
    (3, 1500, 1537, 0.5, False),
    (5, 700, 3000, 0.9, False),
    (4, 4096, 4096, 0.25, True),  # the pipeline's clouds: live slots first
    (1, 4096, 4096, 0.8, False)])  # one row: 32 blocks, points over 8 warps
def test_coral_kernel_at_the_edges_of_its_tiling(cuda, m, q, p, frac, packed):
    args = _inputs(5, m, q, p, cuda, frac, 20.0, packed)
    got = tmoments.neighbor_moments(*args, 1.0)
    _assert_moments(got, tmoments.neighbor_moments_reference(*args, 1.0))
    again = tmoments.neighbor_moments(*args, 1.0)  # no atomics: same bits
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dead tile", "last slot"])
def test_coral_kernel_sparse_masks(cuda, case):
    qs, qm, ps, pm = _inputs(6, 2, 1100, 1600, cuda, 1.0, 15.0)
    pm = torch.zeros_like(pm)
    if case == "dead tile":  # more dead slots than a tile between live ones
        pm[:, :300] = True
        pm[:, 1100:1300] = True
    else:  # both clouds live only in their last slot, query on the point
        pm[:, -1] = True
        qm = torch.zeros_like(qm)
        qm[:, -1] = True
        qs[:, -1] = ps[:, -1]
    got = tmoments.neighbor_moments(qs, qm, ps, pm, 1.0)
    _assert_moments(got, tmoments.neighbor_moments_reference(qs, qm, ps, pm,
                                                             1.0))
    if case == "last slot":
        assert float(got[0].sum()) == 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("m,s,r,frac,packed", [
    (3, 700, 1300, 0.8, False), (2, 130, 50, 0.9, False),
    (1, 4096, 4096, 0.8, False), (12, 4096, 4096, 0.25, True),
    # in-run training: 13 perturbations of one keyframe pair, 4800 slots a
    # cloud (37.5 query blocks, a second compaction pass of 704 slots)
    (13, 4800, 4800, 0.1, True), (13, 4800, 4800, 0.8, False)])
def test_pair_moments_matches_plain_and_four_launches(cuda, m, s, r, frac,
                                                      packed):
    """One launch gives what four plain calls give, within the kernel's
    tolerance, and what four ``neighbor_moments`` launches give bit for bit
    (the same device code), twice."""
    sx, sm, rx, rm = _inputs(7, m, s, r, cuda, frac, 15.0, packed)
    before = tmoments.LAUNCHES
    got = tmoments.pair_moments(sx, sm, rx, rm, 1.0)
    assert tmoments.LAUNCHES == before + 1
    assert got[0].shape == (2, m, s + r)
    assert got[2].shape == (2, m, s + r, 2, 2)
    _assert_moments(got, tmoments.pair_moments_reference(sx, sm, rx, rm, 1.0))
    own = zip(tmoments.neighbor_moments(sx, sm, sx, sm, 1.0),
              tmoments.neighbor_moments(rx, rm, rx, rm, 1.0))
    other = zip(tmoments.neighbor_moments(sx, sm, rx, rm, 1.0),
                tmoments.neighbor_moments(rx, rm, sx, sm, 1.0))
    four = [torch.stack([torch.cat(a, 1), torch.cat(b, 1)])
            for a, b in zip(own, other)]
    again = tmoments.pair_moments(sx, sm, rx, rm, 1.0)
    for g, f, a in zip(got, four, again):
        assert torch.equal(g, f)
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_cuda_tensors_never_reach_the_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(tmoments, "neighbor_moments_reference", boom)
    monkeypatch.setattr(tmoments, "pair_moments_reference", boom)
    before = tmoments.LAUNCHES
    tmoments.neighbor_moments(*_inputs(1, 2, 64, 80, cuda), 1.0)
    tmoments.pair_moments(*_inputs(1, 2, 64, 80, cuda), 1.0)
    torch.cuda.synchronize()
    assert tmoments.LAUNCHES == before + 2


@pytest.mark.cuda
def test_coral_kernel_rejects_mismatched_shapes(cuda):
    qs, qm, ps, pm = _inputs(2, 2, 64, 80, cuda)
    before = tmoments.LAUNCHES
    with pytest.raises(ValueError):
        tmoments.neighbor_moments(qs, qm, ps[:1], pm, 1.0)
    assert tmoments.LAUNCHES == before


def _clouds(seed, m, n, dev, extent=15.0):
    """M pairs of world-frame peak clouds: the second is the first moved by
    a few decimetres, so neighbourhoods overlap as at a true alignment.  At
    ~4 points per square metre a 1 m neighbourhood holds a dozen points and
    its covariance is well conditioned."""
    from tbv_slam_public_torch.core.types import PointCloud

    rng = np.random.default_rng(seed)
    xy = rng.uniform(-extent, extent, (m, n, 2)).astype(np.float32)
    shift = rng.normal(scale=0.2, size=(m, n, 2)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)
    mk = lambda p: PointCloud(xy=t(p), intensity=t(np.ones((m, n), np.float32)),
                              mask=t(rng.uniform(size=(m, n)) < 0.9))
    return mk(xy), mk(xy + shift)


@pytest.mark.cuda
@pytest.mark.parametrize("route,m", [("training", 13), ("online", 12)])
def test_coral_quality_launch_sets(cuda, route, m):
    """The two routes the online path adds, at their widths: the 13
    perturbations of one keyframe pair, and one query broadcast over its 12
    candidates (a stride-0 view, as ``register_and_verify`` hands it on).
    Either is one launch for the four moment sets, and agrees with the plain
    version on the CPU: overlap exactly up to two boundary points, entropies
    to 1e-3."""
    from tbv_slam_public_torch.ops import coral

    src, ref = _clouds(3, m, 4096, cuda)
    if route == "online":
        src = src.map(lambda x: x[0][None].expand((m,) + x.shape[1:]))
    before = tmoments.LAUNCHES
    got = coral.coral_quality(src, ref, radius=1.0)
    torch.cuda.synchronize()
    assert tmoments.LAUNCHES == before + 1
    cpu = lambda c: c.map(lambda x: x.cpu())
    want = coral.coral_quality(cpu(src), cpu(ref), radius=1.0)
    merged = (src.mask.sum(-1) + ref.mask.sum(-1)).cpu()
    assert ((got.overlap.cpu() - want.overlap).abs() * merged <= 2.0).all()
    torch.testing.assert_close(got.joint.cpu(), want.joint, rtol=1e-3,
                               atol=1e-3)
    torch.testing.assert_close(got.sep.cpu(), want.sep, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [13, 12])
def test_coral_kernel_at_online_widths(cuda, m):
    qs, qm, ps, pm = _inputs(4, m, 4096, 4096, cuda)
    qs, qm = (x[0][None].expand((m,) + x.shape[1:]) for x in (qs, qm))
    _assert_moments(tmoments.neighbor_moments(qs, qm, ps, pm, 1.0),
                    tmoments.neighbor_moments_reference(qs, qm, ps, pm, 1.0))
