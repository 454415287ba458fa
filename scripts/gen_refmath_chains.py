"""Write ``tbv_slam_public_torch/csrc/refmath_chains.cu`` from the refmath
chains' bodies (``kernels/refmath.py::chains_source``): one straight-line
kernel a chain.  Run it after changing a chain's body; ``--check`` exits 1
where the file differs from what the bodies make.

    python3 scripts/gen_refmath_chains.py [--check]
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tbv_slam_public_torch.kernels import refmath  # noqa: E402
# the chains' owners register them
from tbv_slam_public_torch.models import (loopclosure, odometry,  # noqa: E402,F401
                                          verification)
from tbv_slam_public_torch.ops import radar  # noqa: E402,F401

PATH = os.path.join(ROOT, "tbv_slam_public_torch", "csrc",
                    "refmath_chains.cu")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--check", action="store_true",
                    help="compare with the file instead of writing it")
    args = ap.parse_args()
    text = refmath.chains_source()
    if args.check:
        with open(PATH) as f:
            same = f.read() == text
        print("refmath_chains.cu is " + ("current" if same else "stale"))
        return 0 if same else 1
    with open(PATH, "w") as f:
        f.write(text)
    print(f"wrote {PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
