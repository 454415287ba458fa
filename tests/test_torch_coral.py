"""Port parity: CorAl moments (the plain versions of ``neighbor_moments`` and
``pair_moments``), CorAl quality and the alignment features, against the JAX
package.

The JAX side's Pallas kernel runs in interpret mode, as tests/test_pallas.py
runs it on the CPU.  The CUDA kernel's own tests, which need a card, are in
the jax-free tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core.config import VerificationConfig
from tbv_slam_public_tpu.core.types import PointCloud as JCloud
from tbv_slam_public_tpu.models import verification as jverif
from tbv_slam_public_tpu.ops import coral as jcoral
from tbv_slam_public_tpu.pallas import coral_moments as jmoments
from tbv_slam_public_torch.core.types import PointCloud as TCloud
from tbv_slam_public_torch.io.convert import cells_from_numpy
from tbv_slam_public_torch.kernels import coral_moments as tmoments
from tbv_slam_public_torch.models import verification as tverif
from tbv_slam_public_torch.ops import coral as tcoral

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

# float32 sums taken in another order (the same bound as test_pallas.py)
RTOL, ATOL = 1e-5, 1e-4
CELL_FIELDS = ("mean", "cov", "normal", "nsamples", "planarity",
               "avg_intensity", "valid")


def _inputs(rng, m, q, p, frac=0.8, extent=30.0):
    return (rng.uniform(-extent, extent, (m, q, 2)).astype(np.float32),
            rng.uniform(size=(m, q)) < frac,
            rng.uniform(-extent, extent, (m, p, 2)).astype(np.float32),
            rng.uniform(size=(m, p)) < frac)


@pytest.mark.parametrize("q,p", [(50, 70), (128, 512), (200, 600)])
def test_plain_moments_match_pallas_interpret(rng, q, p):
    qs, qm, ps, pm = _inputs(rng, 2, q, p)
    got = tmoments.neighbor_moments(*map(torch.as_tensor, (qs, qm, ps, pm)),
                                    2.5)
    for i in range(2):
        want = jmoments.neighbor_moments(
            jnp.asarray(qs[i]), jnp.asarray(qm[i]), jnp.asarray(ps[i]),
            jnp.asarray(pm[i]), 2.5, interpret=True)
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w),
                                       rtol=RTOL, atol=ATOL)


def _dense_moments(qs, qm, ps, pm, radius):
    """The moments over every (query, point) slot pair, masked: the form the
    plain version had before it gathered live slots."""
    rx = ps[:, None, :, 0] - qs[:, :, None, 0]
    ry = ps[:, None, :, 1] - qs[:, :, None, 1]
    fm = ((rx * rx + ry * ry <= radius * radius) & pm[:, None, :]
          & qm[:, :, None]).to(qs.dtype)
    rx, ry = rx * fm, ry * fm
    sxy = (rx * ry).sum(-1)
    return (fm.sum(-1), torch.stack([rx.sum(-1), ry.sum(-1)], -1),
            torch.stack([torch.stack([(rx * rx).sum(-1), sxy], -1),
                         torch.stack([sxy, (ry * ry).sum(-1)], -1)], -2))


@pytest.mark.parametrize("m,q,p,frac,chunk", [
    (3, 300, 500, 0.8, 1 << 28), (13, 480, 480, 0.08, 1 << 28),
    (4, 200, 260, 0.5, 1 << 12), (2, 64, 64, 0.0, 1 << 28)])
def test_live_slot_plain_version_equals_the_dense_form(rng, m, q, p, frac,
                                                       chunk):
    """Gathering each row's live slots changes nothing but the order of the
    float32 sums: counts bit-equal, moments within the kernel's tolerance;
    rows of different live counts, chunks of one row, all dead."""
    qs, qm, ps, pm = map(torch.as_tensor, _inputs(rng, m, q, p, frac, 15.0))
    qm[0, : q // 2] = False  # rows with fewer live slots than others
    got = tmoments.neighbor_moments_reference(qs, qm, ps, pm, 1.5,
                                              chunk_bytes=chunk)
    want = _dense_moments(qs, qm, ps, pm, 1.5)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    if frac:
        assert float(want[0].sum()) > 0


def test_plain_moments_empty_masks(rng):
    qs, _, ps, _ = _inputs(rng, 1, 64, 128, extent=5.0)
    z = lambda n: torch.zeros(1, n, dtype=torch.bool)
    n, s1, s2 = tmoments.neighbor_moments(torch.as_tensor(qs), z(64),
                                          torch.as_tensor(ps), z(128), 1.0)
    want = jmoments.neighbor_moments(
        jnp.asarray(qs[0]), jnp.zeros(64, bool), jnp.asarray(ps[0]),
        jnp.zeros(128, bool), 1.0, interpret=True)
    assert float(n.sum()) == float(jnp.sum(want[0])) == 0.0
    assert float(s1.abs().sum()) == 0.0 and float(s2.abs().sum()) == 0.0


def test_cpu_tensors_take_the_plain_version(rng):
    before = tmoments.LAUNCHES
    args = tuple(map(torch.as_tensor, _inputs(rng, 2, 40, 50)))
    got = tmoments.neighbor_moments(*args, 1.5)
    want = tmoments.neighbor_moments_reference(*args, 1.5)
    assert tmoments.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the plain version's chunking over pairs does not change the result
    chunked = tmoments.neighbor_moments_reference(*args, 1.5,
                                                  chunk_bytes=1)
    for g, w in zip(chunked, want):
        assert torch.equal(g, w)


def _masks(rng, kind, m, n):
    if kind == "empty":
        return np.zeros((m, n), bool)
    if kind == "packed":  # live slots first, as the pipeline's clouds
        return np.arange(n)[None] < rng.integers(n // 8, n // 2, (m, 1))
    return rng.uniform(size=(m, n)) < 0.8


@pytest.mark.parametrize("s,r,kind", [
    (70, 50, "scattered"), (128, 200, "scattered"), (96, 160, "packed"),
    (160, 96, "packed"), (64, 128, "empty")])
def test_plain_pair_moments_match_pallas_interpret(rng, s, r, kind):
    """``pair_moments`` on CPU tensors (its plain version) against four calls
    of the JAX kernel per pair: src and ref of different capacity; index 0
    holds a query's moments over its own cloud, index 1 over the other's,
    the src queries before the ref queries."""
    m = 2
    sx = rng.uniform(-8, 8, (m, s, 2)).astype(np.float32)
    rx = rng.uniform(-8, 8, (m, r, 2)).astype(np.float32)
    sm, rm = _masks(rng, kind, m, s), _masks(rng, kind, m, r)
    before = tmoments.LAUNCHES
    got = tmoments.pair_moments(*map(torch.as_tensor, (sx, sm, rx, rm)), 1.5)
    assert tmoments.LAUNCHES == before
    assert got[0].shape == (2, m, s + r) and got[1].shape == (2, m, s + r, 2) \
        and got[2].shape == (2, m, s + r, 2, 2)
    j = jnp.asarray
    for i in range(m):
        src, ref = (j(sx[i]), j(sm[i])), (j(rx[i]), j(rm[i]))
        for group, cols, q, p in ((0, slice(0, s), src, src),
                                  (1, slice(0, s), src, ref),
                                  (0, slice(s, s + r), ref, ref),
                                  (1, slice(s, s + r), ref, src)):
            want = jmoments.neighbor_moments(*q, *p, 1.5, interpret=True)
            np.testing.assert_array_equal(got[0][group, i, cols].numpy(),
                                          np.asarray(want[0]))
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_allclose(g[group, i, cols].numpy(),
                                           np.asarray(w), rtol=RTOL,
                                           atol=ATOL)
    if kind == "empty":
        assert all(float(g.abs().sum()) == 0.0 for g in got)


@pytest.mark.parametrize("kind,copied", [
    ("bool", False),  # viewed as bytes
    ("uint8", False),
    ("bool, one row for all", False),  # a stride-0 view is read in place
    ("bool, every other slot", True),
    ("float", True),
    ("int64", True)])
def test_masks_reach_the_kernel_as_bytes(rng, kind, copied):
    """What the launcher hands the kernel for a mask: bytes, contiguous along
    the slots, equal to the mask, and a copy only where the layout or the
    type forces one."""
    live = torch.as_tensor(rng.uniform(size=(3, 40)) < 0.5)
    x = {"bool": live, "uint8": live.to(torch.uint8),
         "bool, one row for all": live[0][None].expand(3, -1),
         "bool, every other slot": live[:, ::2],
         "float": live.float() * 2.5, "int64": live.long() * 7}[kind]
    got = tmoments._mask(x)
    assert got.dtype == torch.uint8 and got.stride(1) == 1
    assert torch.equal(got.bool(), x != 0)
    assert (got.data_ptr() != x.data_ptr()) == copied


@pytest.mark.parametrize("kind,copied", [
    ("float32", False),
    ("one cloud for all rows", False),  # a stride-0 view is read in place
    ("rows of a wider tensor", False),
    ("float64", True),
    ("x and y apart", True),
    ("every other point", True)])
def test_points_reach_the_kernel_as_float2_rows(rng, kind, copied):
    """What the launcher hands the kernel for a cloud: float32 (x, y) pairs
    next to each other, contiguous along the slots, 8-byte aligned rows, and
    a copy only where the layout or the type forces one."""
    xy = torch.as_tensor(rng.uniform(-5, 5, (3, 40, 2)).astype(np.float32))
    x = {"float32": xy, "one cloud for all rows": xy[0][None].expand(3, -1, -1),
         "rows of a wider tensor": xy[:, :30],
         "float64": xy.double(),
         "x and y apart": xy.permute(0, 2, 1).contiguous().permute(0, 2, 1),
         "every other point": xy[:, ::2]}[kind]
    got = tmoments._points(x)
    assert got.dtype == torch.float32 and got.stride()[1:] == (2, 1)
    assert got.stride(0) % 2 == 0 and got.data_ptr() % 8 == 0
    assert torch.equal(got, x.float())
    assert (got.data_ptr() != x.data_ptr()) == copied


def test_other_devices_raise():
    t = lambda *s: torch.zeros(s, device="meta")
    with pytest.raises(ValueError):
        tmoments.neighbor_moments(t(1, 4, 2), t(1, 4).bool(), t(1, 4, 2),
                                  t(1, 4).bool(), 1.0)
    with pytest.raises(ValueError):
        tmoments.pair_moments(t(1, 4, 2), t(1, 4).bool(), t(1, 4, 2),
                              t(1, 4).bool(), 1.0)


def _peak_pair(rng, n=600):
    """Two overlapping 'peak clouds' along wall-like structures."""
    t = rng.uniform(0, 40, n)
    base = np.stack([t - 20.0, 0.3 * t + rng.normal(0, 0.3, n)], 1)
    other = base + rng.normal(0, 0.15, base.shape) + [0.2, -0.1]
    inten = rng.uniform(60, 200, n).astype(np.float32)
    mask = rng.uniform(size=n) < 0.9
    return base.astype(np.float32), other.astype(np.float32), inten, mask


@pytest.mark.parametrize("mode", ["entropy", "kl"])
def test_coral_quality_matches(rng, mode):
    a, b, inten, mask = _peak_pair(rng)
    want = jcoral.coral_quality(
        JCloud(xy=jnp.asarray(a), intensity=jnp.asarray(inten),
               mask=jnp.asarray(mask)),
        JCloud(xy=jnp.asarray(b), intensity=jnp.asarray(inten),
               mask=jnp.ones(len(mask), bool)), radius=1.0, mode=mode)
    got = tcoral.coral_quality(
        TCloud(xy=torch.as_tensor(a)[None],
               intensity=torch.as_tensor(inten)[None],
               mask=torch.as_tensor(mask)[None]),
        TCloud(xy=torch.as_tensor(b)[None],
               intensity=torch.as_tensor(inten)[None],
               mask=torch.ones(1, len(mask), dtype=torch.bool)),
        radius=1.0, mode=mode)
    for f in ("joint", "sep", "overlap"):
        np.testing.assert_allclose(float(getattr(got, f)[0]),
                                   float(getattr(want, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    assert bool(got.valid[0]) == bool(want.valid)
    assert float(want.overlap) > 0.3


def test_alignment_features_match():
    """x6 of keyframe pairs from the simulator, at a perturbed pose."""
    from tbv_slam_public_tpu.core.config import (FeatureConfig, RadarConfig)
    from tbv_slam_public_tpu.io import simulate
    from tbv_slam_public_tpu.ops import features as jfeat
    from tbv_slam_public_tpu.ops import radar as jradar

    seq = simulate.make_sequence(num_frames=4, seed=2, num_azimuths=200,
                                 num_range_bins=256, range_res=0.3)
    rc = RadarConfig(num_azimuths=200, num_range_bins=256, range_res=0.3,
                     k_strongest=12, min_distance=1.0, max_distance=75.0)
    fc = FeatureConfig(resolution=3.0, cell_capacity=256, grid_extent=80.0)
    outs = [jradar.kstrongest_filter(jnp.asarray(im), rc)
            for im in seq.images]
    cells = [jfeat.compute_cells(c, fc) for c, _ in outs]
    peaks = [p for _, p in outs]
    vcfg = VerificationConfig()
    src_pose = np.asarray([0.9, 0.05, 0.01], np.float32)
    want = jverif.alignment_features(peaks[1], cells[1],
                                     jnp.asarray(src_pose), peaks[0],
                                     cells[0], jnp.zeros(3), vcfg)
    tc = lambda c: cells_from_numpy(
        {f: np.array(getattr(c, f)) for f in CELL_FIELDS}).map(
            lambda x: x[None])
    tp = lambda p: TCloud(xy=torch.as_tensor(np.array(p.xy))[None],
                          intensity=torch.as_tensor(
                              np.array(p.intensity))[None],
                          mask=torch.as_tensor(np.array(p.mask))[None])
    got = tverif.alignment_features(tp(peaks[1]), tc(cells[1]),
                                    torch.as_tensor(src_pose)[None],
                                    tp(peaks[0]), tc(cells[0]),
                                    torch.zeros(1, 3), vcfg)
    # the CorAl entropies take log(det) of small-neighbourhood covariances;
    # near-degenerate ones amplify float32 summation order, hence 1e-3
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)
    assert float(want[4]) > 10  # CFEAR residuals present


def _wave(rng, m, s, r, live):
    """M pairs of ray-like peak clouds of S and R slots, ``live`` of them
    masked in, the ref cloud moved by 0.2 m."""
    a = rng.uniform(-15, 15, (m, s, 2)).astype(np.float32)
    b = (rng.uniform(-15, 15, (m, r, 2)) + 0.2).astype(np.float32)
    b[:, : min(s, r) // 2] = a[:, : min(s, r) // 2] + rng.normal(
        0, 0.1, (m, min(s, r) // 2, 2)).astype(np.float32)
    return a, rng.uniform(size=(m, s)) < live, b, \
        rng.uniform(size=(m, r)) < live


@pytest.mark.parametrize("mode", ["entropy", "kl"])
@pytest.mark.parametrize("m,s,r,live", [(3, 300, 333, 0.9), (2, 20, 9, 1.0),
                                        (2, 1100, 900, 0.3)])
def test_coral_tail_bit_equal_to_the_reference(mode, m, s, r, live):
    """``coral_quality`` (the plain moments, then ``coral_tail``'s plain
    version: the per-point terms as the reference rounds and flushes them,
    its masked sums in the reference's windowed order) against the JAX
    package's ``coral_quality`` vmapped over M pairs, in both modes: joint,
    sep and overlap bit for bit, the same valid flags (tighter than the
    single-pair test's 1e-5)."""
    import jax

    rng = np.random.default_rng(s + r)
    a, am, b, bm = _wave(rng, m, s, r, live)
    want = jax.jit(jax.vmap(lambda *x: jcoral.coral_quality(
        JCloud(x[0], jnp.zeros(s), x[1]), JCloud(x[2], jnp.zeros(r), x[3]),
        radius=1.0, mode=mode)))(a, am, b, bm)
    t = torch.as_tensor
    got = tcoral.coral_quality(TCloud(t(a), torch.zeros(m, s), t(am)),
                               TCloud(t(b), torch.zeros(m, r), t(bm)),
                               radius=1.0, mode=mode)
    for f in ("joint", "sep", "overlap"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                      err_msg=f)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


def _kernel_tree(v):
    """``csrc/coral_moments.cu``'s ``coral_tail_kernel`` order for the sum
    of one pair's Q terms, in NumPy: each window of 32 slots (half the
    padding in front) added in order from zero, the windows' sums in
    windows of 32 again, level by level through shared memory, the last at
    most 32 in order from zero (Q <= 32: the one window is the sum)."""
    q = len(v)
    f = np.float32
    if q <= 32:
        acc = f(0)
        for x in v:
            acc = f(acc + x)
        return acc

    def level(x):
        n = -(-len(x) // 32)
        front = (n * 32 - len(x)) // 2
        out = []
        for w in range(n):
            acc = f(0)
            for k in range(32):
                i = w * 32 + k - front
                acc = f(acc + (x[i] if 0 <= i < len(x) else f(0)))
            out.append(acc)
        return out

    x = level(list(v))
    while len(x) > 32:
        x = level(x)
    acc = f(0)
    for y in x:
        acc = f(acc + y)
    return acc


@pytest.mark.parametrize("q", [1, 29, 32, 33, 100, 1025, 8192, 9600])
def test_coral_tail_kernel_sums_in_the_tree_order(q):
    """The kernel's reduction (emulated in NumPy) is ``refmath.tree_sum``
    bit for bit, at the paths' query counts (an online loop closure's and a
    wave's 2 x 4,096, training's 2 x 4,800) and at the window edges."""
    from tbv_slam_public_torch.core import refmath as plain

    rng = np.random.default_rng(q)
    v = (rng.normal(size=q) * np.exp(rng.uniform(-8, 8, q))).astype(
        np.float32)
    want = plain.tree_sum(torch.as_tensor(v)[None])[0].numpy()
    assert _kernel_tree(v).view(np.int32) == want.view(np.int32)
