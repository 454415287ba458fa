"""Port parity: ScanContext retrieval pieces and loop-closure helpers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core.config import ScanContextConfig, TBVConfig
from tbv_slam_public_tpu.core.types import PointCloud as JCloud
from tbv_slam_public_tpu.models import loopclosure as jlc
from tbv_slam_public_tpu.ops import coral as jcoral
from tbv_slam_public_tpu.ops import scancontext as jsc
from tbv_slam_public_torch.core.types import PointCloud as TCloud
from tbv_slam_public_torch.models import loopclosure as tlc
from tbv_slam_public_torch.ops import coral as tcoral
from tbv_slam_public_torch.ops import scancontext as tsc

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)

SC = ScanContextConfig()


def _cloud(rng, n=3000, extent=85.0):
    xy = rng.uniform(-extent, extent, (n, 2)).astype(np.float32)
    inten = rng.integers(60, 255, n).astype(np.float32)
    inten[: n // 3] = 100.0  # ties for the strongest-k selections
    return xy, inten, rng.uniform(size=n) < 0.85


def _clouds(xy, inten, mask):
    return (JCloud(xy=jnp.asarray(xy), intensity=jnp.asarray(inten),
                   mask=jnp.asarray(mask)),
            TCloud(xy=torch.as_tensor(xy), intensity=torch.as_tensor(inten),
                   mask=torch.as_tensor(mask)))


@pytest.mark.parametrize("seed", [0, 1])
def test_descriptor_and_keys_exact(seed):
    jc, tc = _clouds(*_cloud(np.random.default_rng(seed)))
    want = np.asarray(jsc.make_descriptor(jc, SC))
    got = tsc.make_descriptor(tc, SC)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).sum() > 500
    # the keys bit for bit, against the functions compiled as the main
    # path compiles them
    np.testing.assert_array_equal(
        tsc.ring_key(got).numpy(),
        np.asarray(jax.jit(jsc.ring_key)(jnp.asarray(want))))
    np.testing.assert_array_equal(
        tsc.sector_key(got).numpy(),
        np.asarray(jax.jit(jsc.sector_key)(jnp.asarray(want))))
    np.testing.assert_array_equal(
        tsc.all_column_shifts(got).numpy(),
        np.asarray(jsc.all_column_shifts(jnp.asarray(want))))


def test_sc_distance_and_retrieve(rng):
    descs = []
    for _ in range(12):
        _, tc = _clouds(*_cloud(rng, 1500))
        descs.append(tsc.make_descriptor(tc, SC).numpy())
    descs = np.stack(descs)
    # a rotated copy of descriptor 0 (shift 7) must be found at shift 7
    descs[5] = np.roll(descs[0], 7, axis=1)
    for i in range(1, 12):
        dj, sj = jsc.sc_distance(jnp.asarray(descs[0]), jnp.asarray(descs[i]))
        dt, st = tsc.sc_distance(torch.as_tensor(descs[0]),
                                 torch.as_tensor(descs[i]))
        assert np.float32(dt).tobytes() == np.float32(dj).tobytes()
        assert int(st) == int(sj)
    keys = descs.mean(-1)
    mask = np.arange(12) < 10
    odom = np.linspace(0, 1, 12).astype(np.float32)
    want = jsc.retrieve(jnp.asarray(descs[0]), jnp.asarray(keys[0]),
                        jnp.asarray(descs), jnp.asarray(keys),
                        jnp.asarray(mask), jnp.asarray(odom),
                        num_candidates=6, search_ratio=0.1)
    got = tsc.retrieve(torch.as_tensor(descs[0]), torch.as_tensor(keys[0]),
                       torch.as_tensor(descs), torch.as_tensor(keys),
                       torch.as_tensor(mask), torch.as_tensor(odom),
                       num_candidates=6, search_ratio=0.1)
    for f in ("index", "shift", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    for f in ("dist", "dist_sc", "dist_odom"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


@pytest.mark.parametrize("count", [1, 2, 7, 30])
def test_odometry_similarity_and_exclusion(rng, count):
    pos = np.cumsum(rng.uniform(-1.5, 1.5, (40, 2)), 0).astype(np.float32)
    pos[count:] = 0.0  # unfilled database slots
    mask = np.arange(40) < count
    np.testing.assert_allclose(
        tsc.odometry_similarity(torch.as_tensor(pos), torch.as_tensor(mask),
                                0.05).numpy(),
        np.asarray(jsc.odometry_similarity(jnp.asarray(pos),
                                           jnp.asarray(mask), 0.05)),
        rtol=1e-5, atol=1e-6)
    assert int(tsc.num_exclude_recent(torch.as_tensor(pos),
                                      torch.as_tensor(mask), 10.0)) == \
        int(jsc.num_exclude_recent(jnp.asarray(pos), jnp.asarray(mask), 10.0))


def test_compact_cloud_exact(rng):
    jc, tc = _clouds(*_cloud(rng, 900))
    want = jcoral.compact_cloud(jc, 256)
    got = tcoral.compact_cloud(tc, 256)
    for f in ("xy", "intensity", "mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


def test_host_local_map_matches(rng):
    """ScansToLocalMap on the host (the reference's _aggregate_local_map)."""
    cfg = TBVConfig()
    jl, tl = jlc.LoopCloser(cfg), tlc.LoopCloser(cfg, device="cpu")
    for i in range(4):
        xy, inten, mask = _cloud(rng, 2500, 60.0)
        pose = np.asarray([2.0 * i, 0.3 * i, 0.05 * i], np.float32)
        jc, tc = _clouds(xy, inten, mask)
        jl.add_keyframe(jc, None, pose)
        tl.add_keyframe(tc, tlc.Cells(*[np.zeros(1)] * 7), pose)
    for q in (0, 2, 3):
        want = jl._aggregate_local_map(q)
        got = tl._aggregate_local_map(q)
        for f in ("xy", "intensity", "mask"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
