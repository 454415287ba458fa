"""The CFEAR cells' statistics (``kernels/cells.py::cell_stats``, plain
version ``ops/features.py::_cell_stats_reference``) on the CPU:

- the port's ``compute_cells`` against the JAX package's on small clouds
  whose coordinates are multiples of 1/64 m, so that the voxel sums (a
  part whose order is still the port's own) are exact in any order, with
  integer and with fractional intensities: bit-equal but for the normals
  and planarities that pass through ``eigh2x2``'s two square roots, which
  are torch's (an ulp off the reference's IEEE root in about 0.65 % of
  values on this CPU; ROADMAP.md section 3 item 2(b)), held within 4
  ulp;
- the weight sum's written-out order (``refmath.tree_sum``) bit-equal to the
  reference's compiled ``jnp.sum`` of the masked weights at several point
  counts;
- the dispatch: a CUDA tensor never reaches the plain version unless asked
  (``plain_on_card``).

The kernel is held to the plain version on the card by the ``cuda`` cases
of ``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbv_slam_public_tpu.core.config import FeatureConfig as JFeatureConfig
from tbv_slam_public_tpu.core.types import PointCloud as JPointCloud
from tbv_slam_public_tpu.ops import features as jfeatures
from tbv_slam_public_torch.core import refmath
from tbv_slam_public_torch.core.config import FeatureConfig
from tbv_slam_public_torch.core.types import PointCloud
from tbv_slam_public_torch.kernels import cells as kcells
from tbv_slam_public_torch.ops import features as tfeatures

# one intra-op thread per worker process (the suite runs several)
torch.set_num_threads(1)

FIELDS = ("mean", "cov", "normal", "nsamples", "planarity", "avg_intensity",
          "valid")


def _cloud(rng, p, live, fractional):
    """p points, the first ``live`` in 12 clusters of surfaces (lines with
    noise) within 40 m, on a 1/64 m grid; intensities integers in [40, 200]
    or with fractions."""
    centres = rng.uniform(-40, 40, (12, 2))
    ang = rng.uniform(0, np.pi, 12)
    k = rng.integers(0, 12, live)
    t = rng.uniform(-4, 4, live)
    xy = centres[k] + t[:, None] * np.stack([np.cos(ang[k]),
                                             np.sin(ang[k])], -1)
    xy += rng.normal(0, 0.15, xy.shape)
    xy = np.round(np.concatenate([xy, np.zeros((p - live, 2))]) * 64) / 64
    inten = rng.integers(40, 200, p).astype(np.float64)
    if fractional:
        inten += rng.uniform(0, 1, p)
    mask = np.arange(p) < live
    return (xy.astype(np.float32), inten.astype(np.float32), mask)


@pytest.mark.parametrize("fractional", [False, True], ids=["integer",
                                                            "fractional"])
@pytest.mark.parametrize("p, live, capacity", [(600, 500, 64),
                                               (1000, 700, 128)])
def test_compute_cells_against_the_reference(fractional, p, live,
                                                  capacity):
    rng = np.random.default_rng(p + int(fractional))
    xy, inten, mask = _cloud(rng, p, live, fractional)
    kw = dict(cell_capacity=capacity, grid_extent=60.0, min_neighbors=4)
    want = jfeatures.compute_cells(JPointCloud(
        xy=jnp.asarray(xy), intensity=jnp.asarray(inten),
        mask=jnp.asarray(mask)), JFeatureConfig(**kw))
    got = tfeatures.compute_cells(PointCloud(
        *map(torch.as_tensor, (xy, inten, mask))), FeatureConfig(**kw))
    assert int(got.valid.sum()) >= capacity // 4
    for f in FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        if f in ("normal", "planarity"):
            assert np.abs(g.astype(np.int64) - w).max() <= 4, f
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("p", [20, 33, 100, 1023, 3360, 4800, 4801, 16000,
                               40000])
def test_weight_sum_in_the_reference_order(p):
    """``refmath.tree_sum`` (the cells' weight sum) of masked fractional
    weights bit-equal to the reference's ``jnp.sum(jnp.where(nbr, w, 0),
    axis=1)`` (XLA's tree reduction: windows of 32, half the padding in
    front)."""
    rng = np.random.default_rng(p)
    w = rng.uniform(0, 150, p).astype(np.float32)
    nbr = rng.uniform(size=(64, p)) < 0.3
    want = jax.jit(lambda n, v: jnp.sum(jnp.where(n, v[None, :], 0.0),
                                        axis=1))(nbr, w)
    got = refmath.tree_sum(torch.where(torch.as_tensor(nbr),
                                       torch.as_tensor(w)[None, :],
                                       torch.zeros(())))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


def test_cell_stats_dispatch():
    """The CPU takes the plain version; no other device reaches it."""
    rng = np.random.default_rng(0)
    xy, inten, mask = (torch.as_tensor(a) for a in _cloud(rng, 200, 150,
                                                          False))
    centroid = xy[:16]
    occupied = torch.ones(16, dtype=torch.bool)
    cfg = FeatureConfig()
    got = kcells.cell_stats(xy, inten, mask, centroid, occupied, cfg)
    want = tfeatures._cell_stats_reference(xy, inten, mask, centroid,
                                           occupied, cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(RuntimeError):
        kcells.cell_stats(*(t.to("meta") for t in (xy, inten, mask,
                                                   centroid, occupied)), cfg)
