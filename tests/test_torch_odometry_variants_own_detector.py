"""Port parity of the odometry variants with each package's own detector,
on both of ``tests/test_torch_odometry_variants.py``'s sequences and under
its bounds (trajectory mean < 0.2 mm and max < 0.5 mm from JAX, keyframe
flags equal); that file's docstring gives the measured gaps and what
holds them.  The cases share its sequences, configurations and reference
runs, and live in a file of their own so that the test runner can place
them on another worker.
"""
import os
import sys

import pytest
import torch

from tbv_slam_public_torch.models import odometry as todo

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_odometry_variants import (  # noqa: E402
    VARIANTS, _assert_trajectory, _configs, _reference, _run, _sequences)

# The suite runs several worker processes on one machine and these tensors are
# small: one intra-op thread per process keeps the workers from
# oversubscribing the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["default", "time_continuous", "p2d",
                                  "cacfar"])
def test_variant_with_own_detector(name):
    _, tc = _configs(VARIANTS.get(name, {}))
    jpose, _, jflags = _reference(name)
    tpose, _, tflags = _run(todo.OdometryPipeline(tc, device="cpu"),
                            _sequences()[0].images)
    assert tflags == jflags
    _assert_trajectory(tpose, jpose)


@pytest.mark.parametrize("name", ["default", "time_continuous", "p2d",
                                  "cacfar"])
def test_variant_with_own_detector_on_the_second_sequence(name):
    """As above on sequence 1 (another seed, radius and step), held to the
    same bounds."""
    _, tc = _configs(VARIANTS.get(name, {}))
    jpose, _, jflags = _reference(name, 1)
    tpose, _, tflags = _run(todo.OdometryPipeline(tc, device="cpu"),
                            _sequences()[1].images)
    assert tflags == jflags
    _assert_trajectory(tpose, jpose)
