"""PyTorch + CUDA port of the TBV radar-SLAM pipeline.

Mirrors the layout of ``tbv_slam_public_tpu`` (the JAX reference):

- ``core``    — config and SE(3) export (copies), timing, SE(2) algebra,
  tensor dataclasses
- ``ops``     — radar detectors (k-strongest, CA-CFAR, BFAR, Cen), CFEAR
  cells, registration, ScanContext, CorAl, quality metrics, logistic
  verifier, pose-graph optimization
- ``kernels`` — hand-written Hopper kernels (``csrc/*.cu``) with their plain
  PyTorch versions; takes the place of ``pallas/``
- ``models``  — odometry pipeline, loop closure, SLAM facade
- ``io``      — checkpoints, numpy <-> tensor conversion, the simulator and
  dataset readers (copies of the jax-free reference modules)
- ``eval``    — KITTI / trajectory / loop metrics, result tables (copies)
- ``harness`` — the CLI (every subcommand of the reference) and the sweep
  job farm
- ``parallel`` — multi-process paths over ``torch.distributed``: sharded
  candidate waves and retrieval, distributed PGO, data-parallel training

Nothing here imports JAX.  The reference forces full-f32 matmuls everywhere
(LM stalls at a worse optimum in reduced precision), so TF32 is switched off
for the whole process at import.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
