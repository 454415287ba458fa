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
from tbv_slam_public_torch.kernels.checks import (REFMATH_LAYOUTS,
                                                  REFMATH_OPS,
                                                  REFMATH_RANGES,
                                                  REFMATH_SPECIAL,
                                                  bits_differ, on_gate_clouds,
                                                  op_operands)

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
    Either is one launch for the four moment sets and one ``coral_tail``
    launch (no refmath op), and agrees with the plain version on the CPU:
    overlap exactly up to two boundary points, entropies to 1e-3."""
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.ops import coral

    src, ref = _clouds(3, m, 4096, cuda)
    if route == "online":
        src = src.map(lambda x: x[0][None].expand((m,) + x.shape[1:]))
    before, tails, ops = tmoments.LAUNCHES, tmoments.TAIL_LAUNCHES, rm.LAUNCHES
    got = coral.coral_quality(src, ref, radius=1.0)
    torch.cuda.synchronize()
    assert tmoments.LAUNCHES == before + 1
    assert tmoments.TAIL_LAUNCHES == tails + 1 and rm.LAUNCHES == ops
    cpu = lambda c: c.map(lambda x: x.cpu())
    want = coral.coral_quality(cpu(src), cpu(ref), radius=1.0)
    merged = (src.mask.sum(-1) + ref.mask.sum(-1)).cpu()
    assert ((got.overlap.cpu() - want.overlap).abs() * merged <= 2.0).all()
    torch.testing.assert_close(got.joint.cpu(), want.joint, rtol=1e-3,
                               atol=1e-3)
    torch.testing.assert_close(got.sep.cpu(), want.sep, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["entropy", "kl"])
@pytest.mark.parametrize("m,n,live", [
    (64, 4096, 0.8),  # an offline loop wave
    (12, 4096, 0.8),  # an online loop closure's candidates
    (13, 4800, 0.1),  # a training pair's perturbations, 10 % live
    (13, 700, 0.9),   # an evaluate-scans pair's (chip_smoke.py's clouds)
    (3, 20, 0.9),     # Q = 40: two windows, Q not a multiple of 32
    (2, 10, 0.9),     # Q <= 32: one window
    (1, 4096, 0.8),   # one pair: a cluster of 8
    (4, 1000, 0.0)])  # every pair dead
def test_coral_tail_bit_equal_to_plain(cuda, mode, m, n, live):
    """``coral_tail`` (one launch) against its plain version on the card,
    given the same moments (the pair kernel's): joint, sep, overlap and
    valid bit for bit, in both modes, at the paths' shapes."""
    from tbv_slam_public_torch.ops import coral

    rng = np.random.default_rng(m + n)
    xy = rng.uniform(-15, 15, (m, n, 2)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=cuda)
    sm = t(np.arange(n)[None] < rng.uniform(0.8, 1.2, (m, 1)) * live * n)
    rm = t(rng.uniform(size=(m, n)) < live)
    moments = tmoments.pair_moments(t(xy), sm, t(xy + rng.normal(
        0, 0.2, xy.shape).astype(np.float32)), rm, 1.0)
    want = coral.coral_tail_reference(*moments, sm, rm, 1e-8, mode)
    for cluster in (0, 1, 2, 3, 8):  # chosen, then forced
        before = tmoments.TAIL_LAUNCHES
        got = coral.CoralResult(*tmoments.coral_tail(
            *moments, sm, rm, 1e-8, mode, cluster=cluster))
        assert tmoments.TAIL_LAUNCHES == before + 1
        assert tmoments.TAIL_CLUSTER == (
            cluster or min(8, max(1, 132 // m), -(-2 * n // 32)))
        for g, w in zip(got[:3], want[:3]):
            assert bits_differ(g, w) == 0, (mode, cluster)
        assert torch.equal(got.valid, want.valid)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [13, 12])
def test_coral_kernel_at_online_widths(cuda, m):
    qs, qm, ps, pm = _inputs(4, m, 4096, 4096, cuda)
    qs, qm = (x[0][None].expand((m,) + x.shape[1:]) for x in (qs, qm))
    _assert_moments(tmoments.neighbor_moments(qs, qm, ps, pm, 1.0),
                    tmoments.neighbor_moments_reference(qs, qm, ps, pm, 1.0))


# ---- the single-device ops without a hand kernel: the card against the CPU
# (the same PyTorch code on both; sin/cos, divisions by a scalar (a multiply
# by its reciprocal on the card) and the order of float sums differ in the
# last bits; index_add_ sums with atomics on the card, and an LM accept test
# may flip on a last bit: poses are held to 1e-3 m and 1e-4 rad)
POSE_M, POSE_RAD = 1e-3, 1e-4


def _radar_image(seed, a=64, r=400):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 90, (a, r)).astype(np.uint8)
    for _ in range(300):
        img[rng.integers(a), rng.integers(r)] = rng.integers(100, 256)
    return img


@pytest.mark.cuda
@pytest.mark.parametrize("detector", ["cacfar_filter", "bfar_filter",
                                      "cen2018_filter"])
def test_detectors_on_the_card_match_the_cpu(cuda, detector):
    import dataclasses

    from tbv_slam_public_torch.core.config import RadarConfig
    from tbv_slam_public_torch.ops import cen, radar

    img = _radar_image(1)
    cfg = dataclasses.replace(
        RadarConfig(num_azimuths=64, num_range_bins=400, range_res=0.2),
        k_strongest=8, cfar_guard_cells=2, cfar_window_size=6,
        cfar_false_alarm_rate=0.05, min_distance=1.0, z_min=40.0)
    fn = getattr(radar if hasattr(radar, detector) else cen, detector)
    got = fn(torch.as_tensor(img, device=cuda), cfg)
    want = fn(torch.as_tensor(img), cfg)
    m = want.mask
    if detector == "cen2018_filter":
        # the Gaussian filter is a convolution: a score on the threshold
        # may flip, so the sets agree but for a few bins
        assert abs(int(got.mask.sum()) - int(m.sum())) <= 2
        return
    assert torch.equal(got.mask.cpu(), m) and int(m.sum()) > 50
    assert torch.equal(got.intensity.cpu()[m], want.intensity[m])
    torch.testing.assert_close(got.xy.cpu()[m], want.xy[m], rtol=0,
                               atol=1e-4)


@pytest.mark.cuda
def test_max_descriptor_and_quality_on_the_card_match_the_cpu(cuda):
    import dataclasses

    from tbv_slam_public_torch.core.config import ScanContextConfig
    from tbv_slam_public_torch.core.types import PointCloud
    from tbv_slam_public_torch.ops import quality, scancontext

    rng = np.random.default_rng(2)
    xy = rng.uniform(-60, 60, (3, 800, 2)).astype(np.float32)
    clouds = [PointCloud(torch.as_tensor(xy + d, device=dev),
                         torch.full((3, 800), 80.0, device=dev),
                         torch.ones(3, 800, dtype=torch.bool, device=dev))
              for d in (0.0, 0.3) for dev in (cuda, torch.device("cpu"))]
    cfg = dataclasses.replace(ScanContextConfig(), desc_function="max")
    got = scancontext.make_descriptor(clouds[0], cfg).cpu()
    want = scancontext.make_descriptor(clouds[1], cfg)
    assert torch.equal(got == cfg.no_point, want == cfg.no_point)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    for metric in ("p2p_quality", "keypoint_repeatability",
                   "cartesian_absdiff_quality"):
        got = getattr(quality, metric)(clouds[2], clouds[0])
        want = getattr(quality, metric)(clouds[3], clouds[1])
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-6)


def _scene(dev):
    """CFEAR cells of three views of one simulated world, [3, C] on
    ``dev``, and their true poses."""
    from tbv_slam_public_torch.core.config import FeatureConfig, RadarConfig
    from tbv_slam_public_torch.core.types import stack_records
    from tbv_slam_public_torch.io import simulate
    from tbv_slam_public_torch.ops import features, radar

    rc = RadarConfig(num_azimuths=200, num_range_bins=256, range_res=0.3,
                     k_strongest=12, min_distance=1.0, max_distance=75.0)
    fc = FeatureConfig(resolution=3.0, cell_capacity=256, grid_extent=80.0)
    world = simulate.make_world(np.random.default_rng(1), num_walls=50,
                                extent=60.0)
    poses = np.asarray([[0.0, 0.0, 0.0], [1.2, 0.6, 0.05],
                        [2.5, 0.9, 0.08]], np.float32)
    cells = [features.compute_cells(radar.kstrongest_filter(
        torch.as_tensor(simulate.render_scan(
            world, p, num_azimuths=200, num_range_bins=256, range_res=0.3,
            rng=np.random.default_rng(2 + i))), rc)[0], fc)
        for i, p in enumerate(poses)]  # on the CPU: both devices get these
    return stack_records(cells).map(lambda x: x.to(dev)), \
        torch.as_tensor(poses, device=dev)


def _assert_poses(got, want):
    got, want = got.cpu().numpy(), want.numpy()
    assert np.abs(got[..., :2] - want[..., :2]).max() < POSE_M, (got, want)
    assert np.abs(got[..., 2] - want[..., 2]).max() < POSE_RAD, (got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["P2D", "time-continuous", "ceres",
                                     "joint"])
def test_registration_variants_on_the_card_match_the_cpu(cuda, variant):
    from tbv_slam_public_torch.core.config import RegistrationConfig
    from tbv_slam_public_torch.ops import registration as reg

    out = []
    for dev in (cuda, torch.device("cpu")):
        cells, true = _scene(dev)
        src = cells.map(lambda x: x[2:3])
        tgt = cells.map(lambda x: x[None, :2])
        tposes, tmask = true[None, :2], torch.ones(1, 2, dtype=torch.bool,
                                                   device=dev)
        cost = "P2D" if variant == "P2D" else "P2L"
        cfg = RegistrationConfig(cost=cost, weight_option=4)
        start = torch.zeros(1, 3, device=dev) + true[1]
        if variant == "time-continuous":
            vel = torch.tensor([[0.9, -0.25, 0.04]], device=dev)
            res = reg.register_time_continuous(src, start, tgt, tposes,
                                               tmask, cfg, vel)
            out.append((res.pose,))
        elif variant == "joint":
            init = true.clone()
            init[1:] += torch.tensor([[0.4, -0.3, 0.03], [-0.3, 0.3, -0.03]],
                                     device=dev)
            res = reg.register_joint(cells, init, tmask[0].new_ones(3),
                                     tmask[0].new_zeros(3), cfg)
            out.append((res.pose,))
        else:
            res = reg.register_window(src, start, tgt, tposes, tmask, cfg)
            if variant == "ceres":
                cov, ok = reg.ceres_covariance(
                    src, res.pose, tgt, tposes, tmask, cfg, res.score,
                    res.num_residuals)
                assert bool(ok[0])
                out.append((res.pose, cov))
            else:
                out.append((res.pose,))
    _assert_poses(out[0][0], out[1][0])
    if variant == "ceres":
        torch.testing.assert_close(out[0][1].cpu(), out[1][1], rtol=1e-2,
                                   atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("override", ["registration.cost=P2D",
                                      "odometry.time_continuous=true"])
def test_batched_step_rows_on_the_card_equal_single_steps(cuda, override):
    """One batched frame step at B = 2 from the same state as two B = 1
    steps: each row equals its own step."""
    from tbv_slam_public_torch.core.config import (
        FeatureConfig, RadarConfig, TBVConfig, apply_overrides,
        parse_cli_overrides)
    from tbv_slam_public_torch.io import simulate
    from tbv_slam_public_torch.models import odometry

    cfg = apply_overrides(TBVConfig(
        radar=RadarConfig(num_azimuths=200, num_range_bins=256,
                          range_res=0.3, k_strongest=12, min_distance=1.0,
                          max_distance=75.0),
        features=FeatureConfig(resolution=3.0, cell_capacity=256,
                               grid_extent=80.0)),
        parse_cli_overrides([override]))
    imgs = torch.as_tensor(np.stack([simulate.make_sequence(
        num_frames=3, seed=s, num_azimuths=200, num_range_bins=256,
        range_res=0.3, traj_kwargs=dict(radius=40.0, step=0.7,
                                        laps=0.12)).images
        for s in (0, 9)], 1), device=cuda)
    st = odometry.init_batched_state(cfg, 2, device=cuda)
    st, _ = odometry.batched_first_frame(st, imgs[0], cfg)
    st, _ = odometry.batched_odometry_step(st, imgs[1], cfg)
    _, both = odometry.batched_odometry_step(st, imgs[2], cfg)
    for r in range(2):
        row = st.map(lambda x: x[r:r + 1])
        _, one = odometry.batched_odometry_step(row, imgs[2, r:r + 1], cfg)
        _assert_poses(both.pose[r:r + 1], one.pose.cpu())
        assert bool(both.fused[r]) == bool(one.fused[0])


@pytest.mark.cuda
def test_descriptor_and_image_sums_repeat_on_the_card(cuda):
    """The sum-mode descriptor and the quality images add in index order on
    the card (no float atomics): two calls on one cloud are bit-equal."""
    from tbv_slam_public_torch.core.config import ScanContextConfig
    from tbv_slam_public_torch.core.types import PointCloud
    from tbv_slam_public_torch.ops import quality, scancontext

    rng = np.random.default_rng(4)
    n = 200_000  # many points a bin, in random order
    cloud = PointCloud(
        torch.as_tensor(rng.uniform(-70, 70, (2, n, 2)).astype(np.float32),
                        device=cuda),
        torch.as_tensor(rng.uniform(60, 255, (2, n)).astype(np.float32),
                        device=cuda),
        torch.as_tensor(rng.uniform(size=(2, n)) < 0.9, device=cuda))
    cfg = ScanContextConfig()
    for fn in (lambda: scancontext.make_descriptor(cloud, cfg),
               lambda: quality.render_cartesian(cloud, 80.0)):
        assert torch.equal(fn(), fn())


@pytest.mark.cuda
def test_parallel_paths_of_one_rank_on_the_card(cuda):
    """Without a process group (a mesh of size 1) on the card: sharded
    retrieval equals ``retrieve`` bit for bit, and distributed PGO corrects
    the Oxford instance's drift as on the CPU."""
    import dataclasses
    import os

    from tbv_slam_public_torch.core.config import PGOConfig
    from tbv_slam_public_torch.eval.trajectory import ate_rmse
    from tbv_slam_public_torch.io import simulate
    from tbv_slam_public_torch.ops import posegraph, scancontext
    from tbv_slam_public_torch.parallel import multihost, pgo, retrieval

    mesh = multihost.make_mesh(cuda)
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, device=cuda)
    desc = rng.uniform(0, 2, (512, 40, 120)).astype(np.float32)
    args = (t(desc[[3, 300]] + 0.01), t(desc[[3, 300]].mean(-1) + 0.01),
            t(desc), t(desc.mean(-1)), t(rng.uniform(size=512) > 0.2),
            t(rng.uniform(size=(2, 512)).astype(np.float32)))
    kw = dict(num_candidates=10, search_ratio=0.1, odometry_coupled=True)
    got = retrieval.sharded_retrieve(mesh, *args, **kw)
    want = scancontext.retrieve(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    z = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                             "oxford_10-12-32_real_odometry.npz"))
    inst = simulate.make_real_odometry_pgo_instance(z["odom"], z["gt"],
                                                    seed=0)
    cfg = dataclasses.replace(PGOConfig(), max_iterations=8)
    m = inst.mask
    et = t(inst.etype[m].astype(np.int64))
    edges = posegraph.make_edges(inst.idx[m], inst.meas[m],
                                 posegraph.default_sqrt_info(et, cfg), et,
                                 m[m], device=cuda)
    res = pgo.optimize_distributed(
        mesh, t(inst.poses), torch.ones(len(inst.poses), dtype=torch.bool,
                                        device=cuda), edges, cfg)
    ate0 = ate_rmse(inst.poses, inst.gt)
    assert ate_rmse(res.poses.cpu().numpy(), inst.gt) < 0.7 * ate0
    assert float(res.cost) < 0.2 * float(res.cost0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [13, 1])
def test_coral_kernel_at_the_dryrun_shapes(cuda, m):
    """The multi-rank dry run's launches: its training step (13
    perturbations of one scan pair a rank) and its pair wave (one pair a
    rank), clouds of 1024 slots, all live, uniform over 160 m x 160 m as
    ``harness/dryrun.py`` draws them."""
    rng = np.random.default_rng(m)
    cloud = lambda: torch.as_tensor(
        rng.uniform(-80, 80, (m, 1024, 2)).astype(np.float32), device=cuda)
    live = torch.ones((m, 1024), dtype=torch.bool, device=cuda)
    args = (cloud(), live, cloud(), live, 1.0)
    got = tmoments.pair_moments(*args)
    _assert_moments(got, tmoments.pair_moments_reference(*args))
    assert float(got[0][0].sum()) >= m * 2048  # each point finds itself


@pytest.mark.cuda
def test_pgo_runs_repeat_bit_for_bit_on_the_card(cuda):
    """The edge-to-node sums add in an order fixed once per graph: two runs
    of the schur solver, and of distributed PGO on a mesh of one, end on
    the same bits.
    (A one-rank and a two-rank run still differ, as in the reference: each
    rank sums its own shard of the edges first.)"""
    import dataclasses
    import os

    from tbv_slam_public_torch.core.config import PGOConfig
    from tbv_slam_public_torch.io import simulate
    from tbv_slam_public_torch.ops import posegraph
    from tbv_slam_public_torch.parallel import multihost, pgo

    z = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                             "oxford_10-12-32_real_odometry.npz"))
    inst = simulate.make_real_odometry_pgo_instance(z["odom"], z["gt"],
                                                    seed=0)
    cfg = dataclasses.replace(PGOConfig(), max_iterations=8)
    m = inst.mask
    t = lambda a: torch.as_tensor(a, device=cuda)
    et = t(inst.etype[m].astype(np.int64))
    edges = posegraph.make_edges(inst.idx[m], inst.meas[m],
                                 posegraph.default_sqrt_info(et, cfg), et,
                                 m[m], device=cuda)
    poses = t(inst.poses)
    nodes = torch.ones(len(inst.poses), dtype=torch.bool, device=cuda)
    n_loop = int((edges.mask & ~posegraph._is_chain(edges)).sum())
    runs = [
        lambda: posegraph.optimize(poses, nodes, edges, cfg, solver="schur",
                                   loop_cap=n_loop),
        lambda: pgo.optimize_distributed(multihost.make_mesh(cuda), poses,
                                         nodes, edges, cfg)]
    for run in runs:
        a, b = run(), run()
        assert torch.equal(a.poses, b.poses) and float(a.cost) < \
            float(a.cost0)


@pytest.mark.cuda
def test_graph_sums_on_the_card_equal_the_cpus(cuda):
    """The fixed-order edge-to-node sums give the card the CPU's bits: the
    same values summed by ``_GraphSums.nodes`` on the card and by
    ``index_add_`` (sequential, in index order) on the CPU."""
    from tbv_slam_public_torch.core.types import GraphEdges
    from tbv_slam_public_torch.ops import posegraph

    rng = np.random.default_rng(0)
    n, e = 500, 4000
    idx = torch.as_tensor(rng.integers(0, n, (e, 2)))
    vb, ve = (torch.as_tensor(rng.normal(size=(e, 3, 3)).astype(np.float32))
              for _ in range(2))
    want = torch.zeros((n, 3, 3)).index_add_(0, idx[:, 0], vb).index_add_(
        0, idx[:, 1], ve)
    edges = GraphEdges(idx=idx.to(cuda), meas=None, sqrt_info=None,
                       etype=None, mask=None)
    sums = posegraph._GraphSums(n, edges)
    for _ in range(2):  # the second call reuses the order
        got = sums.nodes(vb.to(cuda), ve.to(cuda))
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_batched_rows_on_the_card_equal_their_own_steps_bit_for_bit(cuda):
    """At the default configuration each row of a B = 2, 8 and 16 frame
    step is its own B = 1 step bit for bit: the registration's sums do not
    depend on the batch size (``ops/registration.py::_row_sums``)."""
    from tbv_slam_public_torch.core.config import (FeatureConfig, RadarConfig,
                                                   TBVConfig)
    from tbv_slam_public_torch.io import simulate
    from tbv_slam_public_torch.models import odometry

    cfg = TBVConfig(
        radar=RadarConfig(num_azimuths=200, num_range_bins=256,
                          range_res=0.3, k_strongest=12, min_distance=1.0,
                          max_distance=75.0),
        features=FeatureConfig(resolution=3.0, cell_capacity=256,
                               grid_extent=80.0))
    imgs = torch.as_tensor(np.stack([simulate.make_sequence(
        num_frames=4, seed=s, num_azimuths=200, num_range_bins=256,
        range_res=0.3, traj_kwargs=dict(radius=40.0, step=0.7,
                                        laps=0.12)).images
        for s in (0, 9)], 1), device=cuda)

    def run(rows):
        st = odometry.init_batched_state(cfg, len(rows), device=cuda)
        st, out = odometry.batched_first_frame(st, imgs[0, rows], cfg)
        poses = [out.pose]
        for k in range(1, imgs.shape[0]):
            st, out = odometry.batched_odometry_step(st, imgs[k, rows], cfg)
            poses.append(out.pose)
        return torch.stack(poses, 1)

    one = [run([r]) for r in range(2)]
    for b in (2, 8, 16):
        rows = [i % 2 for i in range(b)]
        batch = run(rows)
        for i, r in enumerate(rows):
            assert torch.equal(batch[i:i + 1], one[r]), (b, i)


def _same(a, b) -> bool:
    return bits_differ(a, b) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(REFMATH_RANGES))
def test_refmath_kernel_matches_plain(cuda, op):
    """Each op of ``csrc/refmath.cu`` on 2^22 values and the special values,
    bit-equal to its plain version (NaN payloads aside)."""
    from tbv_slam_public_torch.core import refmath as plain
    from tbv_slam_public_torch.kernels import refmath as rm

    rng = np.random.default_rng(len(op))
    lo, hi = REFMATH_RANGES[op]
    special = REFMATH_SPECIAL
    x = torch.as_tensor(np.concatenate([
        rng.uniform(lo, hi, 1 << 22).astype(np.float32), special]))
    args = [x]
    if op == "atan2":
        args.insert(0, torch.as_tensor(np.concatenate([
            rng.uniform(lo, hi, 1 << 22).astype(np.float32), special[::-1]])))
    before = rm.LAUNCHES
    got = getattr(rm, op)(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert rm.LAUNCHES == before + 1
    want = getattr(plain, op)(*args)
    pairs = zip(got, want) if op == "sincos" else [(got, want)]
    for g, w in pairs:
        assert g.device.type == "cuda" and _same(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", REFMATH_LAYOUTS)
@pytest.mark.parametrize("op", REFMATH_OPS)
def test_refmath_op_layouts_bit_equal_to_plain(cuda, op, layout):
    """Each op kernel (and ``mul``) on contiguous, offset (not 16-byte
    aligned), strided and broadcast operands at 1, 3, 4, 4,097 and 2^19 + 3
    values: one launch a call, bit-equal to its plain version on the same
    operands on the CPU; the strided path makes no copy (every operand that
    is not the output's shape or contiguous is counted, none is made
    contiguous)."""
    from tbv_slam_public_torch.core import refmath as plain
    from tbv_slam_public_torch.kernels import refmath as rm

    rng = np.random.default_rng(len(op) + 7 * len(layout))
    for n in (1, 3, 4, 4097, (1 << 19) + 3):
        args = op_operands(rng, op, n, layout)
        card = [a.to(cuda) if layout != "offset" else
                torch.empty(n + 1, device=cuda)[1:].copy_(a) for a in args]
        if layout == "strided":
            card = [torch.empty(2 * n, device=cuda)[::2].copy_(a)
                    for a in args]
        elif layout == "broadcast" and len(args) == 1:
            card = [args[0][:1].to(cuda).expand(n)]
        before, strided = rm.LAUNCHES, sum(rm.STRIDED_OPERANDS.values())
        got = getattr(rm, op)(*card)
        assert rm.LAUNCHES == before + 1, (op, layout, n)
        made = sum(rm.STRIDED_OPERANDS.values()) - strided
        assert made == sum(not (a.shape == (n,) and a.is_contiguous())
                           for a in card), (op, layout, n, made)
        want = getattr(plain, op)(*args)
        pairs = zip(got, want) if op == "sincos" else [(got, want)]
        for g, w in pairs:
            assert g.is_contiguous() and g.shape == w.shape
            assert _same(g, w), (op, layout, n)


@pytest.mark.cuda
def test_refmath_fma_matches_plain(cuda):
    """The fused multiply-add on 2^22 values, half of them products that
    nearly cancel their addend, bit-equal to the plain version."""
    from tbv_slam_public_torch.core import refmath as plain
    from tbv_slam_public_torch.kernels import refmath as rm

    rng = np.random.default_rng(2)
    n = 1 << 22
    a, b = (torch.as_tensor((rng.normal(size=n) * np.exp(rng.uniform(
        -20, 20, n))).astype(np.float32)) for _ in range(2))
    near = -(a.double() * b.double()).numpy() * (1 + 1e-7 * rng.normal(
        size=n))
    c = torch.as_tensor(np.where(rng.uniform(size=n) < 0.5, near,
                                 rng.normal(size=n)).astype(np.float32))
    got = rm.fma(a.to(cuda), b.to(cuda), c.to(cuda))
    assert _same(got, plain.fma(a, b, c))
    # broadcast operands, as the call sites pass them
    got = rm.fma(a[:8, None].to(cuda), b[None, :16].to(cuda), c[:16].to(cuda))
    assert _same(got, plain.fma(a[:8, None], b[None, :16], c[:16]))


@pytest.mark.cuda
def test_refmath_solve3x3_matches_plain(cuda):
    """The LM step theta - a^{-1} b, a thread a system, bit-equal to the
    plain version on damped normal matrices, near-singular ones and zeros,
    in both of its roundings."""
    from tbv_slam_public_torch.core import refmath as plain
    from tbv_slam_public_torch.kernels import refmath as rm

    rng = np.random.default_rng(3)
    n = 1 << 18
    j = rng.normal(size=(n, 6, 3)).astype(np.float32)
    a = np.einsum("nki,nkj->nij", j, j).astype(np.float32)
    a[: n // 4, 2] = a[: n // 4, 1] * (1 + 1e-6)
    a[-8:] = 0.0
    a = torch.as_tensor(a)
    b = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32))
    t = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32))
    for one in (False, True):
        assert _same(rm.lm_update(t.to(cuda), a.to(cuda), b.to(cuda),
                                  one_system=one),
                     plain.lm_update(t, a, b, one_system=one))


@pytest.mark.cuda
def test_refmath_lu_solve_matches_plain(cuda):
    """The logistic fit's solve, a thread a system, bit-equal to the plain
    version at every size it takes (the fit's matrices, pivoting ones and
    zero pivots, and systems whose operands, pivots and results reach the
    subnormal range, flushed as the reference's thread flushes them)."""
    from tbv_slam_public_torch.core import refmath as plain
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.kernels.checks import (lu_subnormal_systems,
                                                      lu_systems)

    for k in range(1, 8):
        for make in (lu_systems, lu_subnormal_systems):
            h, g = (torch.as_tensor(a) for a in make(
                np.random.default_rng(k), 3000, k))
            assert _same(rm.lu_solve(h.to(cuda), g.to(cuda)),
                         plain.lu_solve(h, g)), (k, make.__name__)


@pytest.mark.cuda
def test_refmath_dot_matches_plain(cuda):
    from tbv_slam_public_torch.core import refmath as plain
    from tbv_slam_public_torch.kernels import refmath as rm

    rng = np.random.default_rng(1)
    for rows in (1, 2, 64, 1000):
        a = torch.as_tensor(rng.uniform(0, 100, (rows, 27)).astype(np.float32))
        b = torch.as_tensor(rng.normal(size=(10, 27)).astype(np.float32))
        assert _same(rm.dot(a.to(cuda), b.to(cuda)), plain.dot(a, b))


@pytest.mark.cuda
def test_sampled_covariance_rows_do_not_depend_on_the_batch(cuda):
    """Each row of ``sampled_covariance`` at B = 2, 8 and 16 is its own
    B = 1 call bit for bit: the quadratic fit adds its terms one fused
    multiply-add at a time (no library product picks the order by B)."""
    from tbv_slam_public_torch.core.config import (FeatureConfig, RadarConfig,
                                                   RegistrationConfig)
    from tbv_slam_public_torch.io import simulate
    from tbv_slam_public_torch.ops import features, radar, registration

    seq = simulate.make_sequence(
        num_frames=3, seed=1, num_azimuths=200, num_range_bins=256,
        range_res=0.3, traj_kwargs=dict(radius=40.0, step=0.7, laps=0.12))
    rc = RadarConfig(num_azimuths=200, num_range_bins=256, range_res=0.3,
                     k_strongest=12, min_distance=1.0, max_distance=75.0)
    fc = FeatureConfig(resolution=3.0, cell_capacity=256, grid_extent=80.0)
    cells = [features.compute_cells(radar.kstrongest_filter(
        torch.as_tensor(im, device=cuda), rc)[0], fc) for im in seq.images]
    cfg = RegistrationConfig(cost="P2L")
    rng = np.random.default_rng(8)
    theta = torch.as_tensor(np.stack(
        [0.7 + rng.uniform(-0.3, 0.3, 16), rng.uniform(-0.3, 0.3, 16),
         rng.uniform(-0.02, 0.02, 16)], -1).astype(np.float32), device=cuda)
    score = torch.as_tensor(rng.uniform(1, 50, 16).astype(np.float32),
                            device=cuda)
    n_res = torch.as_tensor(rng.integers(20, 200, 16), device=cuda)

    def run(rows):
        b = len(rows)
        src = cells[2].map(lambda x: x[None].expand((b,) + x.shape))
        tgt = cells[1].map(lambda x: x[None, None].expand((b, 1) + x.shape))
        return registration.sampled_covariance(
            src, theta[rows], tgt, torch.zeros(b, 1, 3, device=cuda),
            torch.ones(b, 1, dtype=torch.bool, device=cuda), cfg,
            score[rows], n_res[rows])

    one = [run([i]) for i in range(16)]
    for b in (2, 8, 16):
        cov, ok = run(list(range(b)))
        for i in range(b):
            assert torch.equal(cov[i:i + 1], one[i][0]), (b, i)
            assert torch.equal(ok[i:i + 1], one[i][1]), (b, i)


@pytest.mark.cuda
def test_coral_kernel_on_gate_clouds(cuda):
    """Neighbours within an ulp of the radius, half of them where the
    fused and the unfused sum of squares fall on opposite sides of r^2:
    the kernel's counts are its plain version's bit for bit (its sums add
    in its own order where a query has several neighbours)."""
    rng = np.random.default_rng(9)
    m, n = 4, 256
    q, p = on_gate_clouds(rng, m, n, 1.0)
    mask = np.ones((m, n), bool)
    args = [torch.as_tensor(x) for x in (q, mask, p, mask)]
    want = tmoments.neighbor_moments_reference(*args, 1.0)
    got = tmoments.neighbor_moments(*(a.to(cuda) for a in args), 1.0)
    _assert_moments([g.cpu() for g in got], want)


def _lm_call(prob, dev, cost, loss, max_iter, one_system):
    from types import SimpleNamespace

    from tbv_slam_public_torch.ops import registration as treg

    theta0, src, tm, tn, weight, mask, si, prior = prob
    t = lambda x: None if x is None else torch.as_tensor(x, device=dev)
    assoc = treg.Associations(t(tm), t(tn), t(weight), t(mask), t(si))
    return treg._lm_solve(
        t(theta0), SimpleNamespace(mean=t(src)), assoc, cost=cost, loss=loss,
        delta=0.3, max_iter=max_iter, init_lambda=1e-4,
        prior=None if prior is None else tuple(map(t, prior)),
        one_system=one_system)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,max_iter", [
    (2, 3, 37, 20),  # fewer than 256 threads hold leaves, N not 2^k
    (4, 4, 512, 20),  # odometry's window at B = 4 (4096 leaves for P2P)
    (5, 1, 512, 10),  # a loop wave's rows (512 leaves for P2L)
    (3, 5, 512, 20),  # register_joint over 5 scans (2 x 2560 leaves)
    # cell_capacity 2048: P2D's row (16,384 leaves) spread over the
    # cluster's CTAs
    (2, 4, 2048, 20)])
def test_lm_solve_kernel_bit_equal_to_plain(cuda, b, t, c, max_iter):
    """The LM-solve entry of the registration kernel (one launch) against
    the plain version on the card, bit for bit in theta, cost and the last
    relative decrease, over every cost x loss x prior x one_system."""
    from tbv_slam_public_torch.kernels import lm_solve as lm_kernel
    from tbv_slam_public_torch.kernels.checks import lm_problem

    from tbv_slam_public_torch.ops.registration import cost_code

    rng = np.random.default_rng(b * 100 + t)
    for name in ("P2L", "P2D", "P2P"):
        cost = cost_code(name)
        for with_prior in (False, True):
            prob = lm_problem(rng, b, t, c, name, with_prior)
            for loss in range(6):
                for one in (False, True):
                    before = lm_kernel.LAUNCHES
                    got = _lm_call(prob, cuda, cost, loss, max_iter, one)
                    assert lm_kernel.LAUNCHES == before + 1
                    with lm_kernel.plain_on_card():
                        want = _lm_call(prob, cuda, cost, loss, max_iter, one)
                    bad = [bits_differ(g, w) for g, w in zip(got, want)]
                    assert not any(bad), (name, loss, with_prior, one, bad)


@pytest.mark.cuda
def test_a_cuda_tensor_never_reaches_the_plain_lm_solve(cuda, monkeypatch):
    """On CUDA tensors ``_lm_solve`` is the kernel: the plain version's
    cost pass is never called, and the plain entry itself raises outside
    the test-only ``plain_on_card``."""
    from types import SimpleNamespace

    from tbv_slam_public_torch.kernels.checks import lm_problem
    from tbv_slam_public_torch.ops import registration as treg

    prob = lm_problem(np.random.default_rng(1), 2, 2, 64, "P2P", True)

    def refuse(*a, **k):
        raise AssertionError("the plain cost pass ran on a CUDA tensor")

    monkeypatch.setattr(treg, "_cost_grad_hess", refuse)
    out = _lm_call(prob, cuda, 2, 1, 5, False)
    assert all(x.is_cuda for x in out)
    t = lambda x: torch.as_tensor(x, device=cuda)
    with pytest.raises(RuntimeError, match="plain LM solve"):
        treg._lm_solve_reference(
            t(prob[0]), SimpleNamespace(mean=t(prob[1])),
            treg.Associations(*(t(x) for x in prob[2:6])), cost=2, loss=1,
            delta=0.1, max_iter=2, init_lambda=1e-4)


def _window_args(prob, dev, cfg):
    from tbv_slam_public_torch.core.types import Cells

    t = lambda k: torch.as_tensor(prob[k], device=dev)

    def cells(side):
        f = lambda k: t(f"{side}_{k}")
        return Cells(mean=f("mean"), cov=f("cov"), normal=f("normal"),
                     nsamples=f("nsamples"), planarity=f("planarity"),
                     avg_intensity=torch.zeros_like(f("nsamples")),
                     valid=f("valid"))

    prior = dict(guess=t("guess"), guess_sqrt_info=t("sqrt_info")) \
        if "guess" in prob else {}
    return (cells("src"), t("pose0"), cells("tgt"), t("tgt_poses"),
            t("scan_mask"), cfg), prior


def _window_differ(got, want) -> int:
    """Values of two ``RegistrationResult``s that differ (the pose and
    score in their bits)."""
    return sum(bits_differ(getattr(got, f), getattr(want, f))
               for f in ("pose", "score")) + sum(
        int((getattr(got, f) != getattr(want, f)).sum())
        for f in ("num_residuals", "iterations", "success"))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,ct", [
    (2, 3, 37, 41),  # fewer than 256 threads a CTA, N not 2^k, Ct != C
    (1, 4, 512, 512),  # the odometry step
    (4, 4, 512, 512),  # batched odometry
    (12, 1, 512, 512),  # an online loop wave
    (2, 4, 2048, 2048)])  # cell_capacity 2048
def test_register_window_kernel_bit_equal_to_plain(cuda, b, t, c, ct):
    """``register_window`` (one launch of the window kernel) against the
    plain version on the card, bit for bit in pose, score, residual count
    and iterations, over every cost x loss, each with a prior or none,
    one_system or not and a weight option 0-4 in turn."""
    import itertools

    from tbv_slam_public_torch.core.config import RegistrationConfig
    from tbv_slam_public_torch.kernels import lm_solve as lm_kernel
    from tbv_slam_public_torch.kernels.checks import window_problem
    from tbv_slam_public_torch.ops import registration as treg

    rng = np.random.default_rng(b * 1000 + c)
    probs = [window_problem(rng, b, t, c, ct, with_prior=p)
             for p in (False, True)]
    grid = itertools.product(("P2L", "P2D", "P2P"), ("none", "huber",
                                                     "cauchy", "softlone",
                                                     "tukey", "combined"))
    for i, (cost, loss) in enumerate(grid):
        cfg = RegistrationConfig(cost=cost, loss=loss, weight_option=i % 5,
                                 loss_limit=0.3)
        args, prior = _window_args(probs[i % 2], cuda, cfg)
        one = b == 1 and i % 3 == 0
        before = dict(lm_kernel.LAUNCHES_BY_ENTRY)
        got = treg.register_window(*args, one_system=one, **prior)
        assert lm_kernel.LAUNCHES_BY_ENTRY["window"] == \
            before.get("window", 0) + 1
        assert lm_kernel.LAUNCHES_BY_ENTRY["solve"] == before.get("solve", 0)
        with lm_kernel.plain_on_card():
            want = treg.register_window(*args, one_system=one, **prior)
        assert _window_differ(got, want) == 0, (cost, loss, i)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,cost", [(1, 4, 512, "P2P"),
                                        (3, 1, 512, "P2L"),
                                        (2, 3, 256, "P2D")])
def test_register_window_bit_identical_at_every_cluster_size(cuda, b, t, c,
                                                             cost):
    """The window kernel forced to K = 1, 2, 4 and 8 CTAs a row gives the
    same bits (its sums follow one pairwise tree whatever K), equal to the
    plain version's."""
    from tbv_slam_public_torch.core.config import RegistrationConfig
    from tbv_slam_public_torch.kernels import lm_solve as lm_kernel
    from tbv_slam_public_torch.kernels.checks import window_problem
    from tbv_slam_public_torch.ops import registration as treg

    prob = window_problem(np.random.default_rng(c + b), b, t, c, c,
                          with_prior=True)
    cfg = RegistrationConfig(cost=cost)
    args, prior = _window_args(prob, cuda, cfg)
    with lm_kernel.plain_on_card():
        want = treg.register_window(*args, **prior)
    src, pose0, tgt, tposes, smask, _ = args
    code = treg.cost_code(cost)
    for k in (1, 2, 4, 8):
        pose, score, n_res, used = lm_kernel.register_window(
            pose0, src.mean, src.normal, src.nsamples, src.planarity,
            src.valid, tposes, tgt.mean, tgt.normal, tgt.cov, tgt.valid,
            smask, tgt.nsamples, tgt.planarity, cost=code, loss=treg.loss_code(cfg.loss), delta=cfg.loss_limit,
            max_inner=cfg.max_inner_iterations, init_lambda=cfg.init_lambda,
            max_outer=cfg.max_outer_iterations,
            min_outer=cfg.min_outer_iterations, radius=cfg.radius,
            angle_gate_cos=float(np.cos(np.radians(cfg.angle_gate_deg))),
            weight_option=cfg.weight_option,
            regularization=cfg.regularization, cov_scale=cfg.cov_scale,
            score_tolerance=cfg.score_tolerance, guess=prior["guess"],
            sqrt_info=prior["guess_sqrt_info"], cluster=k)
        assert bits_differ(pose, want.pose) == 0, k
        assert bits_differ(score, want.score) == 0, k
        assert torch.equal(n_res, want.num_residuals), k
        assert torch.equal(used, want.iterations), k


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,cost,inner", [(1, 4, 512, "P2P", 20),
                                              (12, 1, 512, "P2L", 10),
                                              (2, 3, 256, "P2D", 20),
                                              (3, 2, 64, "P2L", 7)])
def test_register_window_bit_identical_at_every_batch(cuda, b, t, c, cost,
                                                      inner):
    """The window kernel forced to 1, 2, 3 and 4 candidates a pass along a
    run of rejections gives the same bits as the plain version; one
    candidate a pass makes the serial loop's 1 + max_inner passes an outer
    iteration, more make no more; on rows that accept then reject, and on
    a row whose every cost is NaN (a NaN source weight: every candidate
    rejected, lambda up to 1e6)."""
    from tbv_slam_public_torch.core.config import RegistrationConfig
    from tbv_slam_public_torch.kernels import lm_solve as lm_kernel
    from tbv_slam_public_torch.kernels.checks import window_problem
    from tbv_slam_public_torch.ops import registration as treg

    prob = window_problem(np.random.default_rng(c + b + 7), b, t, c, c,
                          with_prior=True)
    prob["src_nsamples"][-1] = np.nan  # weight option 1: a NaN cost
    cfg = RegistrationConfig(cost=cost, weight_option=1,
                             max_inner_iterations=inner, init_lambda=1e-9)
    args, prior = _window_args(prob, cuda, cfg)
    with lm_kernel.plain_on_card():
        want = treg.register_window(*args, **prior)
    src, pose0, tgt, tposes, smask, _ = args
    code = treg.cost_code(cost)
    serial = None
    for batch in (1, 2, 3, 4):
        passes = torch.zeros(b, dtype=torch.int32, device=cuda)
        pose, score, n_res, used = lm_kernel.register_window(
            pose0, src.mean, src.normal, src.nsamples, src.planarity,
            src.valid, tposes, tgt.mean, tgt.normal, tgt.cov, tgt.valid,
            smask, tgt.nsamples, tgt.planarity, cost=code,
            loss=treg.loss_code(cfg.loss), delta=cfg.loss_limit,
            max_inner=inner, init_lambda=cfg.init_lambda,
            max_outer=cfg.max_outer_iterations,
            min_outer=cfg.min_outer_iterations, radius=cfg.radius,
            angle_gate_cos=float(np.cos(np.radians(cfg.angle_gate_deg))),
            weight_option=cfg.weight_option,
            regularization=cfg.regularization, cov_scale=cfg.cov_scale,
            score_tolerance=cfg.score_tolerance, guess=prior["guess"],
            sqrt_info=prior["guess_sqrt_info"], batch=batch, passes=passes)
        assert bits_differ(pose, want.pose) == 0, batch
        assert bits_differ(score, want.score) == 0, batch
        assert torch.equal(n_res, want.num_residuals), batch
        assert torch.equal(used, want.iterations), batch
        if batch == 1:
            serial = passes.clone()
            ran = want.num_residuals > 1
            assert torch.equal(serial[ran], (used * (1 + inner)).to(
                torch.int32)[ran]), (serial, used)
        assert (passes <= serial).all(), (batch, passes, serial)
    assert torch.isnan(want.score[-1])


@pytest.mark.cuda
def test_window_and_evaluation_read_broadcast_rows(cuda):
    """One query's cells broadcast over 12 candidates (a stride-0 batch,
    the online loop closure's form), the targets a view with a unit scan
    axis: the window, ``evaluate_cost`` and ``sampled_covariance`` read
    them in place through their batch strides, bit-equal to the plain
    versions on the same views."""
    from tbv_slam_public_torch.core.config import RegistrationConfig
    from tbv_slam_public_torch.kernels import lm_solve as lm_kernel
    from tbv_slam_public_torch.kernels.checks import window_problem
    from tbv_slam_public_torch.ops import registration as treg

    prob = window_problem(np.random.default_rng(21), 12, 1, 512, 512)
    cfg = RegistrationConfig(cost="P2L", max_inner_iterations=10)
    (src, pose0, tgt, tposes, smask, _), _ = _window_args(prob, cuda, cfg)
    src = src.map(lambda x: x[:1].expand(x.shape))
    tgt = tgt.map(lambda x: x[:, 0][:, None])
    args = (src, pose0, tgt, tposes, smask, cfg)
    got = treg.register_window(*args)
    cost, n = treg.evaluate_cost(*args[:5], cfg)
    cov, convex = treg.sampled_covariance(*args[:5], cfg, cost, n)
    with lm_kernel.plain_on_card():
        want = treg.register_window(*args)
        want_cost, want_n = treg.evaluate_cost(*args[:5], cfg)
        want_cov, want_convex = treg.sampled_covariance(*args[:5], cfg,
                                                        cost, n)
    assert _window_differ(got, want) == 0
    assert bits_differ(cost, want_cost) == 0 and torch.equal(n, want_n)
    assert bits_differ(cov, want_cov) == 0
    assert torch.equal(convex, want_convex)


@pytest.mark.cuda
def test_register_joint_solves_bit_equal_to_plain(cuda):
    """``register_joint`` on the card (its LM solves through the kernel's
    solve entry, one launch an outer iteration) equals its plain version
    bit for bit."""
    from tbv_slam_public_torch.core.config import RegistrationConfig
    from tbv_slam_public_torch.kernels import lm_solve as lm_kernel
    from tbv_slam_public_torch.kernels.checks import window_problem
    from tbv_slam_public_torch.ops import registration as treg

    prob = window_problem(np.random.default_rng(8), 1, 5, 256, 256)
    (_, _, tgt, tposes, _, _), _ = _window_args(prob, cuda,
                                                RegistrationConfig())
    scans = tgt.map(lambda x: x[0])
    mask = torch.ones(5, dtype=torch.bool, device=cuda)
    fixed = torch.zeros(5, dtype=torch.bool, device=cuda)
    fixed[0] = True
    for cost in ("P2P", "P2L", "P2D"):
        cfg = RegistrationConfig(cost=cost, max_outer_iterations=3)
        before = lm_kernel.LAUNCHES_BY_ENTRY["solve"]
        got = treg.register_joint(scans, tposes[0], mask, fixed, cfg)
        assert lm_kernel.LAUNCHES_BY_ENTRY["solve"] == before + 3
        with lm_kernel.plain_on_card():
            want = treg.register_joint(scans, tposes[0], mask, fixed, cfg)
        assert _window_differ(got, want) == 0, cost


@pytest.mark.cuda
def test_a_cuda_tensor_never_reaches_the_plain_window(cuda, monkeypatch):
    """On CUDA tensors ``register_window`` is the kernel: neither the plain
    association nor the plain cost pass is called, and the plain entry
    itself raises outside the test-only ``plain_on_card``."""
    from tbv_slam_public_torch.core.config import RegistrationConfig
    from tbv_slam_public_torch.kernels.checks import window_problem
    from tbv_slam_public_torch.ops import registration as treg

    prob = window_problem(np.random.default_rng(4), 2, 2, 64, 64, True)
    args, prior = _window_args(prob, cuda, RegistrationConfig())

    def refuse(*a, **k):
        raise AssertionError("the plain window ran on a CUDA tensor")

    monkeypatch.setattr(treg, "associate", refuse)
    monkeypatch.setattr(treg, "_cost_grad_hess", refuse)
    out = treg.register_window(*args, **prior)
    assert out.pose.is_cuda and out.iterations.is_cuda
    with pytest.raises(RuntimeError, match="plain register_window"):
        treg._register_window_reference(*args, **prior)


# the sampled covariance's grid (``sampled_covariance``'s defaults)
GRID = (0.4, 0.0043625, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,ct", [
    (2, 3, 37, 41),  # fewer than 256 threads a CTA, N not 2^k, Ct != C
    (64, 1, 512, 512),  # an offline loop wave
    (12, 1, 512, 512),  # an online loop closure's candidates
    (13, 1, 512, 512),  # a training pair's perturbations
    (13, 1, 192, 192),  # an evaluate-scans pair's, at chip_smoke.py's cells
    (1, 4, 512, 512)])  # odometry's sampled covariance
def test_evaluation_entry_bit_equal_to_plain(cuda, b, t, c, ct):
    """``evaluate_cost`` and ``sampled_covariance`` (one launch of the
    registration kernel's evaluation entry each, the targets placed in the
    world inside it: no ``world_targets`` site launch) against their plain
    versions on the card, bit for bit:
    the cost and the residual count, the 27 sampled costs and their fit,
    the covariance and its convexity."""
    from tbv_slam_public_torch.kernels import lm_solve as lm_kernel
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.kernels.checks import (evaluation_configs,
                                                      window_problem)
    from tbv_slam_public_torch.ops import registration as treg

    prob = window_problem(np.random.default_rng(b * 100 + c), b, t, c, ct)
    pinv, offs = treg._quad_fit_pinv(*GRID, cuda)
    for cfg in evaluation_configs():
        args, _ = _window_args(prob, cuda, cfg)
        args = args[:5]
        before = dict(lm_kernel.LAUNCHES_BY_ENTRY)
        sites = rm.LAUNCHES_BY_OP["world_targets"]
        cost, n_res = treg.evaluate_cost(*args, cfg)
        cov, convex = treg.sampled_covariance(*args, cfg, cost, n_res)
        assert dict(lm_kernel.LAUNCHES_BY_ENTRY) == dict(
            before, evaluate=before.get("evaluate", 0) + 2)
        assert rm.LAUNCHES_BY_OP["world_targets"] == sites
        costs, count, q, _, _ = treg._evaluate_on_card(
            *args, cfg, offsets=offs, pinv=pinv)
        with lm_kernel.plain_on_card():
            want_cost, want_n = treg.evaluate_cost(*args, cfg)
            want_cov, want_convex = treg.sampled_covariance(
                *args, cfg, cost, n_res)
            want_costs, want_q = treg._sampled_fit_reference(*args, cfg,
                                                             *GRID)
        tag = (cfg.cost, cfg.loss, cfg.weight_option)
        assert bits_differ(cost, want_cost) == 0, tag
        assert torch.equal(n_res, want_n) and torch.equal(count, want_n), tag
        assert bits_differ(costs, want_costs) == 0, tag
        assert bits_differ(q, want_q) == 0, tag
        assert bits_differ(cov, want_cov) == 0, tag
        assert torch.equal(convex, want_convex), tag
        assert (want_n > 1).any(), tag


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,cost", [(64, 1, 512, "P2L"),
                                        (3, 1, 512, "P2D"),
                                        (1, 4, 512, "P2P")])
def test_evaluation_entry_bit_identical_at_every_cluster_size(cuda, b, t, c,
                                                              cost):
    """The evaluation entry forced to K = 1, 2, 4 and 8 CTAs a row gives
    the same costs, counts, fit, covariance and convexity (its cost sums
    follow one pairwise tree whatever K), equal to the plain version's."""
    from tbv_slam_public_torch.core.config import RegistrationConfig
    from tbv_slam_public_torch.kernels import lm_solve as lm_kernel
    from tbv_slam_public_torch.kernels.checks import window_problem
    from tbv_slam_public_torch.ops import registration as treg

    prob = window_problem(np.random.default_rng(c + b + 1), b, t, c, c)
    cfg = RegistrationConfig(cost=cost, loss="cauchy", weight_option=4)
    args, _ = _window_args(prob, cuda, cfg)
    src, pose, tgt, tposes, smask = args[:5]
    with lm_kernel.plain_on_card():
        want_costs, want_q = treg._sampled_fit_reference(
            src, pose, tgt, tposes, smask, cfg, *GRID)
        score, want_n = treg.evaluate_cost(src, pose, tgt, tposes, smask,
                                           cfg)
        want_cov, want_convex = treg._covariance_from_fit(
            want_q, treg.cost_code(cost), score, want_n, 4.0)
    code = treg.cost_code(cost)
    pinv, offs = treg._quad_fit_pinv(*GRID, cuda)
    for k in (1, 2, 4, 8):
        costs, count, q, cov, convex = lm_kernel.evaluate(
            pose, src.mean, src.normal, src.nsamples, src.planarity,
            src.valid, tposes, tgt.mean, tgt.normal, tgt.cov, tgt.valid,
            smask, tgt.nsamples, tgt.planarity, cost=code, loss=treg.loss_code(cfg.loss), delta=cfg.loss_limit,
            radius=cfg.radius,
            angle_gate_cos=float(np.cos(np.radians(cfg.angle_gate_deg))),
            weight_option=cfg.weight_option,
            regularization=cfg.regularization, cov_scale=cfg.cov_scale,
            offsets=offs, pinv=pinv, cluster=k,
            covariance=(score, want_n, 4.0, treg.DEFAULT_COV_DIAG))
        assert bits_differ(costs, want_costs) == 0, k
        assert bits_differ(q, want_q) == 0, k
        assert torch.equal(count, want_n), k
        assert bits_differ(cov, want_cov) == 0, k
        assert torch.equal(convex, want_convex), k


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c", [(64, 1, 512), (12, 1, 512), (1, 4, 512)])
def test_sampled_covariance_is_one_launch_without_a_host_sync(cuda, b, t, c):
    """On CUDA tensors ``sampled_covariance`` is one evaluation launch,
    nothing else (no refmath op or site, no library call), and never waits
    on the card: it runs under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from tbv_slam_public_torch.core.config import RegistrationConfig
    from tbv_slam_public_torch.kernels import lm_solve as lm_kernel
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.kernels.checks import window_problem
    from tbv_slam_public_torch.ops import registration as treg

    prob = window_problem(np.random.default_rng(b + c), b, t, c, c)
    cfg = RegistrationConfig(cost="P2L")
    args = _window_args(prob, cuda, cfg)[0][:5]
    cost, n = treg.evaluate_cost(*args, cfg)
    treg.sampled_covariance(*args, cfg, cost, n)  # uploads the grid once
    torch.cuda.synchronize()
    entries, ops = dict(lm_kernel.LAUNCHES_BY_ENTRY), dict(rm.LAUNCHES_BY_OP)
    torch.cuda.set_sync_debug_mode("error")
    try:
        cov, convex = treg.sampled_covariance(*args, cfg, cost, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert dict(lm_kernel.LAUNCHES_BY_ENTRY) == dict(
        entries, evaluate=entries.get("evaluate", 0) + 1)
    assert dict(rm.LAUNCHES_BY_OP) == ops
    assert cov.shape == (b, 3, 3) and convex.shape == (b,)


@pytest.mark.cuda
def test_a_cuda_tensor_never_reaches_the_plain_evaluation(cuda, monkeypatch):
    """On CUDA tensors ``evaluate_cost`` and ``sampled_covariance`` are the
    evaluation entry: neither the plain association nor the plain cost pass
    is called, and the plain versions raise outside the test-only
    ``plain_on_card``."""
    from tbv_slam_public_torch.core.config import RegistrationConfig
    from tbv_slam_public_torch.kernels.checks import window_problem
    from tbv_slam_public_torch.ops import registration as treg

    prob = window_problem(np.random.default_rng(6), 2, 1, 64, 64)
    cfg = RegistrationConfig(cost="P2L")
    args = _window_args(prob, cuda, cfg)[0][:5]

    def refuse(*a, **k):
        raise AssertionError("the plain evaluation ran on a CUDA tensor")

    monkeypatch.setattr(treg, "associate", refuse)
    monkeypatch.setattr(treg, "_cost_only", refuse)
    cost, n = treg.evaluate_cost(*args, cfg)
    cov, convex = treg.sampled_covariance(*args, cfg, cost, n)
    assert cost.is_cuda and n.is_cuda and cov.is_cuda and convex.is_cuda
    with pytest.raises(RuntimeError, match="plain evaluate_cost"):
        treg._evaluate_cost_reference(*args, cfg)
    with pytest.raises(RuntimeError, match="plain sampled_covariance"):
        treg._sampled_covariance_reference(*args, cfg, cost, n)


@pytest.mark.cuda
def test_refmath_loop_dot_matches_plain(cuda):
    """``loop_dot`` (the logistic gradient's sum in the reference's loop
    order) on the card against its plain version, bit for bit, at every
    loop shape: n = 1..128 and the online learner's and the training
    step's row counts."""
    from tbv_slam_public_torch.core import refmath as plain
    from tbv_slam_public_torch.kernels import refmath as rm

    rng = np.random.default_rng(3)
    for n in list(range(1, 129)) + [260, 353, 1287]:
        x = torch.as_tensor((rng.normal(size=(7, n)) * np.exp(rng.uniform(
            -4, 4, (1, n)))).astype(np.float32))
        v = torch.as_tensor(rng.normal(size=n).astype(np.float32))
        assert bits_differ(rm.loop_dot(x.to(cuda), v.to(cuda)),
                           plain.loop_dot(x, v)) == 0, n


def _site_operands(site, dev, rng):
    """Operands of one refmath site at a path's shape (a few special angles
    and coordinates among them)."""
    # the sites' owners register them (registration imports core/se2.py)
    from tbv_slam_public_torch.ops import radar, registration  # noqa: F401

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def poses(*shape):
        p = np.stack([rng.uniform(-60, 60, shape), rng.uniform(-60, 60, shape),
                      rng.uniform(-7, 7, shape)], -1).astype(np.float32)
        flat = p.reshape(-1, 3)
        k = min(len(flat), len(REFMATH_SPECIAL))
        flat[:k, 2] = REFMATH_SPECIAL[:k]
        return t(p)

    pts = lambda *shape: t(rng.uniform(-80, 80, shape + (2,)))
    if site in ("compose", "relative"):
        return (poses(300), poses(1)), {}
    if site == "inverse":
        return (poses(4, 50),), {}
    if site in ("apply", "rotate"):
        return (poses(12), pts(12, 4096)), {}
    if site == "interpolate":
        return (poses(200), poses(200), t(rng.uniform(0, 1, 200))), {}
    if site == "rotmat":
        return (poses(500)[:, 2],), {}
    if site == "norm2":
        return (pts(4608),), {}
    if site == "world_targets":
        b, tt, c = 2, 4, 512
        cov = rng.normal(size=(b, tt, c, 2, 2)).astype(np.float32)
        cov[:, :, ::7] = 0.0
        return (poses(b, tt), pts(b, tt, c), pts(b, tt, c), t(cov),
                torch.as_tensor(rng.uniform(size=(b, tt, c)) < 0.8,
                                device=dev),
                torch.as_tensor(rng.uniform(size=(b, tt)) < 0.7,
                                device=dev)), {}
    return (pts(4800), t([0.7, -0.05, 0.02])), dict(ccw=True)


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["compose", "relative", "inverse", "apply",
                                  "rotate", "interpolate", "rotmat", "norm2",
                                  "world_targets", "motion_compensate"])
def test_refmath_site_matches_plain(cuda, site):
    """Each refmath site: one launch on the card, bit-equal to its plain
    version (the op-by-op body) on the CPU; world_targets with and without
    the covariances."""
    from tbv_slam_public_torch.kernels import refmath as rm

    ts, opts = _site_operands(site, cuda, np.random.default_rng(9))
    variants = [ts] + ([ts[:3] + (None,) + ts[4:]]
                       if site == "world_targets" else [])
    for args in variants:
        rm.LAUNCHES_BY_OP.clear()
        got = rm.site(site, *args, **opts)
        assert dict(rm.LAUNCHES_BY_OP) == {site: 1}
        want = rm._PLAIN[site](*(None if a is None else a.cpu()
                                 for a in args), **opts)
        got, want = (got, want) if isinstance(got, tuple) else ((got,),
                                                                (want,))
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert g.is_cuda and bits_differ(g, w) == 0


@pytest.mark.cuda
def test_refmath_cumsum_matches_plain(cuda):
    """``detect``'s travelled distance in the reference's blocked order on
    the card, bit for bit, at the capacities the loop stage uses, at every
    level count of the one-block path, across its switch to the path that
    keeps the levels in device memory (16,384 values), and up to 2^20."""
    from tbv_slam_public_torch.kernels import refmath as rm

    rng = np.random.default_rng(10)
    for n in (1, 15, 16, 17, 128, 1000, 1152, 4608, 16 ** 3 + 1, 16384,
              16385, 70000, 2 ** 20):
        x = torch.as_tensor(rng.uniform(0, 3, n).astype(np.float32))
        assert bits_differ(rm.cumsum(x.to(cuda)), rm._PLAIN["cumsum"](x)) \
            == 0, n
    # a vector that is not 16-byte aligned, signed values and zeros
    x = torch.as_tensor(rng.uniform(-3, 3, 4609).astype(np.float32))
    x[::7] = 0.0
    assert bits_differ(rm.cumsum(x.to(cuda)[1:]), rm._PLAIN["cumsum"](x[1:])) \
        == 0


@pytest.mark.cuda
def test_a_cuda_tensor_never_reaches_a_plain_site(cuda, monkeypatch):
    """On CUDA tensors every site is its kernel: no plain version runs."""
    from tbv_slam_public_torch.kernels import refmath as rm

    def refuse(*a, **k):
        raise AssertionError("a plain site ran on a CUDA tensor")

    rng = np.random.default_rng(11)
    for site in rm.SITES:
        ts, opts = _site_operands(site, cuda, rng)
        monkeypatch.setitem(rm._PLAIN, site, refuse)
        out = rm.site(site, *ts, **opts)
        out = out if isinstance(out, tuple) else (out,)
        assert all(o.is_cuda for o in out if o is not None)


def _cell_inputs(dev, seed, case="random"):
    """A cloud and its selected cells: ``random`` (4,800 points in 24
    clusters, the default configuration), ``on_gate`` (points within an ulp
    of the radius), ``cfear3_oxford`` (16,000 points, the preset's
    k_strongest 40 at 400 azimuths and its 3 m radius) or ``beyond_stage``
    (30,000 points, more than the staged design's shared memory holds, at
    the preset's radius)."""
    from tbv_slam_public_torch.core.config import FeatureConfig, cfear3_oxford
    from tbv_slam_public_torch.core.types import PointCloud
    from tbv_slam_public_torch.kernels.checks import cell_gate_cloud
    from tbv_slam_public_torch.ops import features as tf

    rng = np.random.default_rng(seed)
    cfg = cfear3_oxford().features if case in ("cfear3_oxford",
                                               "beyond_stage") else \
        FeatureConfig()
    if case == "on_gate":
        return tuple(torch.as_tensor(a, device=dev) for a in cell_gate_cloud(
            rng, 512, cfg.resolution)) + (cfg,)
    p = {"cfear3_oxford": 16000, "beyond_stage": 30000}.get(case, 4800)
    xy = rng.uniform(-60, 60, (24, 2))[rng.integers(0, 24, p)] + \
        rng.normal(0, 1.0, (p, 2))
    cloud = PointCloud(torch.as_tensor(xy.astype(np.float32), device=dev),
                       torch.as_tensor(rng.uniform(40, 200, p).astype(
                           np.float32), device=dev),
                       torch.as_tensor(rng.uniform(size=p) < 0.9, device=dev))
    return (cloud.xy, cloud.intensity, cloud.mask) + \
        tf.select_cells(cloud, cfg) + (cfg,)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "on_gate", "cfear3_oxford",
                                  "beyond_stage"])
def test_cell_stats_kernel_bit_equal_to_plain(cuda, case):
    """``cell_stats`` on the card against its plain version on the card,
    bit for bit (fractional intensities: the weight sum's order shows), one
    launch a call, two launches the same bits; at the default's 4,800
    points and at the cfear3_oxford preset's 16,000 (the staged design),
    and at 30,000 (the global-memory design)."""
    from tbv_slam_public_torch.kernels import cells as kc

    args = _cell_inputs(cuda, 12, case)
    kc.LAUNCHES = 0
    got = kc.cell_stats(*args)
    again = kc.cell_stats(*args)
    assert kc.LAUNCHES == 2
    with kc.plain_on_card():
        want = kc.cell_stats(*args)
    assert int(want[-1].sum()) > 50
    for g, a, w in zip(got, again, want):
        assert g.is_cuda and bits_differ(g, w) == 0 and \
            bits_differ(g, a) == 0


@pytest.mark.cuda
def test_a_cuda_tensor_never_reaches_the_plain_cell_stats(cuda, monkeypatch):
    """On CUDA tensors ``compute_cells`` runs the kernel: the plain version
    is never called, and it raises outside ``plain_on_card``."""
    from tbv_slam_public_torch.core.types import PointCloud
    from tbv_slam_public_torch.ops import features as tf

    xy, inten, mask, cen, occ, cfg = _cell_inputs(cuda, 13)
    with pytest.raises(RuntimeError, match="plain cell_stats"):
        tf._cell_stats_reference(xy, inten, mask, cen, occ, cfg)

    def refuse(*a, **k):
        raise AssertionError("the plain cell_stats ran on a CUDA tensor")

    monkeypatch.setattr(tf, "_cell_stats_reference", refuse)
    cells = tf.compute_cells(PointCloud(xy, inten, mask), cfg)
    assert cells.mean.is_cuda and cells.valid.is_cuda


def _chain_operands(name, dev, rng):
    """Operands of one refmath chain at about its path's shape, special
    angles and coordinates among them, the newest keyframe a strided view
    of its window."""
    from tbv_slam_public_torch.core.config import OdometryConfig
    from tbv_slam_public_torch.models import (loopclosure, odometry,  # noqa
                                              verification)
    from tbv_slam_public_torch.ops import radar  # noqa: F401

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def poses(*shape, extent=60.0):
        p = np.stack([rng.uniform(-extent, extent, shape),
                      rng.uniform(-extent, extent, shape),
                      rng.uniform(-3.3, 3.3, shape)], -1).astype(np.float32)
        flat = p.reshape(-1, 3)
        k = min(len(flat), len(REFMATH_SPECIAL))
        flat[:k, 2] = REFMATH_SPECIAL[:k]
        flat[-1, 2] = np.float32(np.pi)
        return t(p)

    pts = lambda *shape: t(rng.uniform(-80, 80, shape + (2,)))
    if name == "odometry_pose_tail":
        n = 300
        base = poses(n)
        window = poses(n, 4)
        return (base + poses(n, extent=1.0) * 0.5,
                torch.as_tensor(rng.uniform(size=n) < 0.8, device=dev),
                base + 0.05, base - poses(n, extent=1.0), poses(n, extent=1.0),
                window[:, -1]), odometry.pose_tail_options(OdometryConfig())
    if name == "motion_compensate_pair":
        return (pts(4800), pts(4800), t([0.7, -0.05, 0.02])), dict(ccw=True)
    if name == "loop_guess":
        return (poses(64), poses(64)[:, 2]), {}
    if name == "local_map":
        return (poses(2, 1, 1), poses(2, 3, 1), pts(2, 3, 4800)), {}
    return (poses(12, 1), pts(12, 4096), poses(12, 1), pts(12, 4096)), {}


CHAINS = ["odometry_pose_tail", "motion_compensate_pair", "loop_guess",
          "local_map", "alignment_apply"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CHAINS)
def test_refmath_chain_matches_plain(cuda, name):
    """Each refmath chain: one launch on the card, counted under its name,
    bit-equal to its plain version on the CPU, two launches the same bits."""
    from tbv_slam_public_torch.kernels import refmath as rm

    ts, opts = _chain_operands(name, cuda, np.random.default_rng(14))
    rm.LAUNCHES_BY_OP.clear()
    got = rm.chain(name, *ts, **opts)
    again = rm.chain(name, *ts, **opts)
    assert dict(rm.LAUNCHES_BY_OP) == {name: 2}
    want = rm.chain(name, *(a.cpu() for a in ts), **opts)
    got, again, want = ((x,) if isinstance(x, torch.Tensor) else x
                        for x in (got, again, want))
    for g, a, w in zip(got, again, want):
        assert g.is_cuda and bits_differ(g, w) == 0 and bits_differ(g, a) == 0


@pytest.mark.cuda
def test_a_cuda_tensor_never_reaches_a_plain_chain(cuda, monkeypatch):
    """On CUDA tensors every chain is its kernel: no site's plain version
    runs."""
    from tbv_slam_public_torch.kernels import refmath as rm

    def refuse(*a, **k):
        raise AssertionError("a plain site ran on a CUDA tensor")

    rng = np.random.default_rng(15)
    for name in CHAINS:
        ts, opts = _chain_operands(name, cuda, rng)
        for site in list(rm._ELEMENT_PLAIN):
            monkeypatch.setitem(rm._ELEMENT_PLAIN, site, refuse)
        out = rm.chain(name, *ts, **opts)
        out = out if isinstance(out, tuple) else (out,)
        assert all(o.is_cuda for o in out)


@pytest.mark.cuda
def test_ceres_covariance_runs_without_a_host_sync(cuda):
    """``ceres_covariance``'s tail after its Hessian is one launch of the
    refmath op ``ceres_covariance``: no library call and no host
    synchronisation (under ``torch.cuda.set_sync_debug_mode("error")``
    after a warm-up call), its flags and covariances the CPU plain
    version's on the same Hessians (rank-deficient ones among them, whose
    rounded smallest eigenvalue may pass the gate and whose inverse then
    holds infinities, in both packages alike), and on 2^14 Hessians of
    every kind (``kernels/checks.py::ceres_hessians``)."""
    from tbv_slam_public_torch.core import refmath as plain
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.kernels.checks import ceres_hessians
    from tbv_slam_public_torch.ops import registration as treg

    rng = np.random.default_rng(16)
    j = rng.normal(size=(64, 40, 3))
    h = np.einsum("bki,bkj->bij", j, j).astype(np.float32)
    h[::4, 2] = h[::4, 1]  # singular
    h[::4, :, 2] = h[::4, :, 1]
    args = (torch.as_tensor(h), torch.full((64,), 2.5),
            torch.as_tensor(rng.integers(0, 200, 64)), treg.COST_P2L)
    card = (args[0].to(cuda), args[1].to(cuda), args[2].to(cuda), args[3])
    treg._ceres_from_hessian(*card)
    torch.cuda.synchronize()
    rm.LAUNCHES_BY_OP.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cov, ok = treg._ceres_from_hessian(*card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert dict(rm.LAUNCHES_BY_OP) == {"ceres_covariance": 1}
    want_cov, want_ok = treg._ceres_from_hessian(*args)
    assert bits_differ(ok, want_ok) == 0 and 0 < int(want_ok.sum()) < 64
    assert bits_differ(cov, want_cov) == 0
    hh, score, n_res = (torch.as_tensor(a)
                        for a in ceres_hessians(rng, 1 << 14))
    for p2l in (True, False):
        got = rm.ceres_covariance(hh.to(cuda), score.to(cuda),
                                  n_res.to(cuda), p2l=p2l)
        want = plain.ceres_covariance(hh, score, n_res, p2l=p2l)
        assert bits_differ(got[1], want[1]) == 0
        assert bits_differ(got[0], want[0]) == 0


# ---- the per-site and per-chain kernels, ScanContext, the sqrt information -

def _layouts(dev):
    """Site operands the path does not give in this form: strided and offset
    views, broadcast poses, a transposed cloud, poses near +-pi."""
    g = torch.Generator().manual_seed(23)
    r = lambda *s: (torch.randn(*s, generator=g) * 20).to(dev)
    big = r(6, 40, 5)
    near = r(64, 3)
    near[:, 2] = torch.tensor(np.float32(np.pi)) - torch.rand(
        64, generator=g).to(dev) * 1e-6
    near[::2, 2] *= -1
    return [
        ("compose", (r(1, 3), near), {}),
        ("relative", (big[:, :3, 0], big[:, 1:4, 2]), {}),
        ("inverse", (r(3, 4, 3)[:, 1:],), {}),
        ("apply", (near[:12], r(12, 33, 2)), {}),
        ("rotate", (r(3), r(2, 50).t()), {}),
        ("interpolate", (near[:8], near[8:16].flip(0), r(8).abs() / 40), {}),
        ("rotmat", (near[::2, 2],), {}),
        ("norm2", (r(2, 30, 2).transpose(0, 1),), {}),
        ("world_targets", (r(2, 4, 3), r(2, 4, 9, 2), r(2, 4, 9, 2),
                           r(2, 4, 9, 2, 2).transpose(-1, -2),
                           r(2, 4, 9) > 0, r(2, 4) > 0), {}),
        ("motion_compensate", (r(2, 40).t(), r(3)), dict(ccw=False)),
    ]


@pytest.mark.cuda
def test_site_kernels_on_strided_and_broadcast_operands(cuda):
    """Every site's kernel on operands read through their strides (views,
    transposes, offsets) and broadcast, angles near +-pi: bit-equal to the
    plain version on the CPU, one launch each."""
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.ops import radar, registration  # noqa: F401

    for site, ts, opts in _layouts(cuda):
        rm.LAUNCHES_BY_OP.clear()
        got = rm.site(site, *ts, **opts)
        assert dict(rm.LAUNCHES_BY_OP) == {site: 1}, site
        want = rm._PLAIN[site](*(None if t is None else t.cpu() for t in ts),
                               **opts)
        got, want = (got, want) if isinstance(got, tuple) else ((got,),
                                                                (want,))
        for a, b in zip(got, want):
            if a is not None:
                assert bits_differ(a, b) == 0, site


@pytest.mark.cuda
def test_pose_tail_gates_on_both_sides(cuda):
    """The pose tail's kernel where the sanity gate and the keyframe gate
    fall on each side (motions at, just under and just over their limits,
    registrations that failed), angles near +-pi, the newest keyframe a
    strided view: bit-equal to its plain version."""
    from tbv_slam_public_torch.core.config import OdometryConfig
    from tbv_slam_public_torch.kernels import refmath as rm
    from tbv_slam_public_torch.models import odometry

    oc = OdometryConfig()
    opts = odometry.pose_tail_options(oc)
    n = 600
    rng = np.random.default_rng(31)
    base = np.zeros((n, 3), np.float32)
    base[:, 2] = np.float32(np.pi) - rng.uniform(0, 1e-5, n).astype(
        np.float32)
    base[1::2, 2] *= -1
    step = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    # speeds around the limit, keyframe distances around the gate
    scale = np.float32(oc.vel_limit * oc.sensor_period) * rng.choice(
        [0.5, 0.999999, 1.0, 1.000001, 2.0], n).astype(np.float32)
    step[:, :2] *= scale[:, None] / np.linalg.norm(step[:, :2], axis=1,
                                                   keepdims=True)
    step[:, 2] *= 0.01
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    window = t(np.repeat(base[:, None], 4, 1) - rng.uniform(
        0, 2 * oc.min_keyframe_dist, (n, 4, 1)).astype(np.float32))
    ts = (t(base + step), torch.as_tensor(rng.uniform(size=n) < 0.8,
                                          device=cuda),
          t(base + step * 0.9), t(base), t(step * 1.0001), window[:, -1])
    got = rm.chain("odometry_pose_tail", *ts, **opts)
    want = rm.chain_plain("odometry_pose_tail", *(x.cpu() for x in ts),
                          **opts)
    fuse = want[3]
    assert 0 < int(fuse.sum()) < n  # the gate falls on both sides
    for a, b in zip(got, want):
        assert bits_differ(a, b) == 0


@pytest.mark.cuda
def test_scancontext_kernels_match_plain(cuda):
    """The keys, the ring-key distance (coupled and not, a mask broadcast
    over the augmentations) and the pairwise distance at retrieve's [B, A,
    K] (a rolled copy, zero columns, an empty descriptor, the query
    broadcast over the candidates): bit-equal to the plain versions on the
    CPU, one launch each."""
    from tbv_slam_public_torch.kernels import refmath as rm

    rng = np.random.default_rng(37)

    def desc(*shape):
        x = (rng.integers(60, 255, shape) * rng.integers(0, 6, shape)
             / 1000.0).astype(np.float32)
        x[rng.uniform(size=shape) < 0.6] = 0.0
        return x

    b, a, k, n = 3, 5, 10, 200
    q = desc(b, a, 40, 120)
    db = desc(n, 40, 120)
    db[7] = np.roll(q[0, 0], 11, axis=1)
    db[8][:, :60] = 0.0
    db[9] = 0.0
    t = lambda x: torch.as_tensor(x, device=cuda)
    for ring in (True, False):
        got = rm.sc_key(t(q), ring=ring)
        assert bits_differ(got, rm._PLAIN["sc_key"](torch.as_tensor(q),
                                                    ring=ring)) == 0
    keys = rm._PLAIN["sc_key"](torch.as_tensor(db))
    qk = rm._PLAIN["sc_key"](torch.as_tensor(q))
    mask = torch.as_tensor(rng.uniform(size=(b, 1, n)) < 0.9)
    odom = torch.as_tensor(rng.uniform(0, 1, (b, 1, n)).astype(np.float32))
    for o in (odom, None):
        got = rm.sc_ring_distance(qk.to(cuda), keys.to(cuda), mask.to(cuda),
                                  None if o is None else o.to(cuda))
        want = rm._PLAIN["sc_ring_distance"](qk, keys, mask, o)
        assert bits_differ(got, want) == 0
    idx = torch.as_tensor(rng.integers(0, n, (b, a, k)))
    idx[0, 0, :3] = torch.tensor([7, 8, 9])
    cands = torch.as_tensor(db)[idx]
    rm.LAUNCHES_BY_OP.clear()
    dist, shift = rm.sc_distance(t(q)[..., None, :, :], cands.to(cuda))
    assert dict(rm.LAUNCHES_BY_OP) == {"sc_distance": 1}
    wd, ws = rm._PLAIN["sc_distance"](torch.as_tensor(q)[..., None, :, :],
                                      cands)
    assert bits_differ(dist, wd) == 0 and torch.equal(shift.cpu(), ws)
    assert int(shift[0, 0, 0]) == 109  # the roll found
    # the ring-key distance reads float32 keys and similarity: any other
    # float type raises rather than being read as float32
    for i, dtype in ((0, torch.float64), (1, torch.float16),
                     (3, torch.float64)):
        args = [qk.to(cuda), keys.to(cuda), mask.to(cuda), odom.to(cuda)]
        args[i] = args[i].to(dtype)
        with pytest.raises(TypeError):
            rm.sc_ring_distance(*args)


@pytest.mark.cuda
def test_measured_sqrt_info_matches_plain(cuda):
    """``measured_sqrt_info``'s kernel (inverse, scale, Cholesky factor,
    fallback) bit-equal to its plain version on SPD, singular, zero,
    negative definite and asymmetric covariances, one launch."""
    from tbv_slam_public_torch.kernels import refmath as rm

    rng = np.random.default_rng(41)
    e = 4096
    m = rng.normal(size=(e, 3, 3)).astype(np.float32)
    cov = ((m @ m.transpose(0, 2, 1) + 0.3 * np.eye(3)) * np.exp(
        rng.uniform(-12, 2, (e, 1, 1)))).astype(np.float32)
    cov[:20, 2] = 0.0
    cov[:20, :, 2] = 0.0
    cov[20] = 0.0
    cov[21:60] *= -1.0
    cov[60:100, 0, 1] += 1.0
    scale = torch.as_tensor(rng.choice([1.0, 1e-3], e).astype(np.float32))
    fb = torch.diag_embed(torch.as_tensor(rng.uniform(1, 9, (e, 3)).astype(
        np.float32)))
    rm.LAUNCHES_BY_OP.clear()
    got = rm.measured_sqrt_info(torch.as_tensor(cov, device=cuda),
                                scale.to(cuda), fb.to(cuda))
    assert dict(rm.LAUNCHES_BY_OP) == {"measured_sqrt_info": 1}
    want = rm._PLAIN["measured_sqrt_info"](torch.as_tensor(cov), scale, fb)
    assert bits_differ(got, want) == 0
    assert torch.equal(want[21:60], fb[21:60])
