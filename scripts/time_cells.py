#!/usr/bin/env python3
"""The ``cell_stats`` kernel of several trees or build variants on one card,
in turns: its time by CUDA events behind a device-side spin, at phase 4's
clouds of ``chip_smoke.py`` (400 x 3768 bins, default configuration, 4,800
points, 512 cells) and at the cfear3_oxford preset's (k_strongest 40:
16,000 points, 3 m radius), each held bit for bit against the plain version
on the card.

A run is a fresh process on one tree (its package first on ``sys.path``)
with optional ``nvcc`` defines (``csrc/cells.cu`` reads ``CELLS_WARPS``,
the cells a block, and ``CELLS_BATCH``, the windows whose loads a warp
issues together).  A variant is ``TREE[:NAME=VALUE,...][@SET,...]`` (a
tree whose kernel takes only phase 4's clouds runs with ``@phase4``); the
order is the variants, then backwards, so that drift of the card shows.
One JSON line a run, then one with all runs and the card's name and power
limit:

    python3 scripts/time_cells.py [--sets phase4,cfear3_oxford] VARIANT ...
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(tree: str, defines: list, sets: list, reps: int) -> dict:
    """One variant, in this process."""
    sys.path.insert(0, os.path.abspath(tree))
    sys.path.insert(1, os.path.join(ROOT, "scripts"))
    import numpy as np
    import torch

    import torch_workload as wl
    from tbv_slam_public_torch.core.config import PRESETS
    from tbv_slam_public_torch.kernels import build
    from tbv_slam_public_torch.kernels import cells as kc
    from tbv_slam_public_torch.ops import features as tf
    from tbv_slam_public_torch.ops import radar

    build.NVCC_FLAGS = build.NVCC_FLAGS + [f"-D{d}" for d in defines]
    build.library()
    dev = torch.device("cuda")
    images = wl.revisiting_sequence(8, circle_frames=200).images
    base = wl.sensor_config()
    oxford = PRESETS["cfear3_oxford"]()
    cfgs = {"phase4": (base.radar, base.features),
            "cfear3_oxford": (oxford.radar, oxford.features)}
    out = dict(tree=tree, defines=defines)
    for name in sets:
        rcfg, fcfg = cfgs[name]
        times, digest = [], hashlib.sha256()
        for img in images[:4]:
            cloud = radar.filter_scan(torch.as_tensor(img, device=dev),
                                      rcfg)[0]
            cen, occ = tf.select_cells(cloud, fcfg)
            args = (cloud.xy, cloud.intensity, cloud.mask, cen, occ, fcfg)
            got = kc.cell_stats(*args)
            with kc.plain_on_card():
                want = kc.cell_stats(*args)
            for g, w in zip(got, want):
                if not torch.equal(g.view(torch.uint8), w.view(torch.uint8)):
                    raise AssertionError(f"{name}: the kernel differs from "
                                         f"the plain version")
                digest.update(g.cpu().numpy().tobytes())
            torch.cuda.synchronize()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(50_000_000)
            t0.record()
            for _ in range(reps):
                kc.cell_stats(*args)
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1) / reps)
        out[name] = dict(ms=float(np.mean(times)), ms_by_cloud=times,
                         points=int(cloud.xy.shape[0]),
                         cells=int(cen.shape[0]),
                         digest=digest.hexdigest()[:16])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sets", default="phase4,cfear3_oxford")
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--run", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("variants", nargs="+")
    a = ap.parse_args()
    if a.run:
        tree, _, defs = a.variants[0].partition(":")
        res = run(tree, [d for d in defs.split(",") if d],
                  a.sets.split(","), a.reps)
        print("RESULT " + json.dumps(res), flush=True)
        return
    runs = []
    for v in a.variants + a.variants[::-1]:
        v, _, sets = v.partition("@")
        sets = sets or a.sets
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run", "--sets",
             sets, "--reps", str(a.reps), v], capture_output=True, text=True,
            cwd=ROOT)
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("RESULT ")]
        if proc.returncode != 0 or not line:
            sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
            raise SystemExit(f"{v}: exit {proc.returncode}")
        runs.append(json.loads(line[0][7:]))
        print(line[0], flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main()
