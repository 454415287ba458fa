"""The port's sensor-size workload, shared by ``chip_smoke.py`` (phases 4
and 9), ``scripts/ab_torch_trees.py`` and ``scripts/profile_torch_step.py``,
so that the three time the same frames and the same loop stage.

The simulator at 400 x 3768 bins of 0.0438 m on a circle of radius
0.11 m a frame that it drives 1.25 times (so that it revisits its start),
the default configuration at that size, the odometry checkpoint's round
trip through ``simple_graph.npz``, and the offline loop stage
(``run_offline_slam``: loop closure and cholesky PGO).  The package is
imported from whichever tree is first on ``sys.path`` (the A/B runs put
another tree there).
"""
import os
import tempfile
import time

import torch

SENSOR = dict(num_azimuths=400, num_range_bins=3768, range_res=0.0438)


def revisiting_sequence(n_frames: int, seed: int = 7, circle_frames=None):
    """``n_frames`` frames on the circle sized for ``circle_frames``
    (default ``n_frames``)."""
    from tbv_slam_public_torch.io import simulate

    circle = n_frames if circle_frames is None else circle_frames
    return simulate.make_sequence(
        num_frames=n_frames, seed=seed, **SENSOR,
        traj_kwargs=dict(radius=0.11 * circle, step=0.8, laps=1.25))


def sensor_config():
    """The default configuration at the sensor's size."""
    from tbv_slam_public_torch.core.config import RadarConfig, TBVConfig

    return TBVConfig(radar=RadarConfig(**SENSOR))


def checkpoint_graph(pipe):
    """The odometry run's simple graph, saved and loaded as the CLI's
    ``slam`` stage reads it."""
    from tbv_slam_public_torch.io import checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "simple_graph.npz")
        checkpoint.save_simple_graph(path, checkpoint.from_odometry(pipe))
        return checkpoint.load_simple_graph(path)


def loop_stage(cfg, graph, dev, warm: bool = True):
    """(seconds, result) of ``run_offline_slam`` on ``graph``, after one
    untimed run when ``warm``."""
    from tbv_slam_public_torch.models.slam import run_offline_slam

    if warm:
        run_offline_slam(cfg, graph, solver="cholesky", device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam = run_offline_slam(cfg, graph, solver="cholesky", device=dev)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, slam
