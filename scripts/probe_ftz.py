#!/usr/bin/env python3
"""Where the card flushes a float32 result to zero under ``.ftz``: before or
after rounding.

The reference's x86 threads (FTZ) flush a result only if it is subnormal
after rounding: a product just below 2^-126 whose rounding gives 2^-126 is
kept.  ``csrc/refmath.cuh``'s ``mul_ftz``, ``fma_ftz`` and ``add_ftz`` (one
``.ftz`` instruction each) equal the kernels' ``daz()`` of the plain
operation only if the card does the same.  This builds a small CUDA library
(``nvcc``, sm_90a, into ``build/probe_ftz/``), runs ``mul.rn.ftz``,
``fma.rn.ftz`` and ``add.rn.ftz`` on operands whose exact result lies just
below 2^-126 (rounding up to it), on subnormals (one on the tie
2^-126 - 2^-150) and just above, and compares each with the exact result
rounded with an unbounded exponent and flushed after rounding.  Prints one JSON line and the card's name and
power limit; exits 1 if any result differs.

    python3 scripts/probe_ftz.py
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = r'''
extern "C" __global__ void probe(const float* a, const float* b,
                                 const float* c, float* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float m, f, s;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(m) : "f"(a[i]), "f"(b[i]));
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(f) : "f"(a[i]), "f"(b[i]), "f"(c[i]));
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(s) : "f"(a[i]), "f"(c[i]));
  out[3 * i] = m;
  out[3 * i + 1] = f;
  out[3 * i + 2] = s;
}
extern "C" int probe_launch(const void* a, const void* b, const void* c,
                            void* out, int n) {
  probe<<<(n + 127) / 128, 128>>>((const float*)a, (const float*)b,
                                   (const float*)c, (float*)out, n);
  cudaDeviceSynchronize();
  return (int)cudaGetLastError();
}
'''


def flushed(x: np.ndarray) -> np.ndarray:
    """float64 values (exact results) rounded to float32 as FTZ after
    rounding does: rounded to 24 significant bits with an unbounded
    exponent (ties to even), then a signed zero where that is below
    2^-126."""
    m, e = np.frexp(x)
    r = np.ldexp(np.round(m * 2.0 ** 24) / 2.0 ** 24, e)
    return np.where(np.abs(r) < 2.0 ** -126, np.copysign(0.0, x),
                    r).astype(np.float32)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_ftz: no CUDA device", file=sys.stderr)
        return 1
    out_dir = os.path.join(ROOT, "build", "probe_ftz")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = os.path.join(out_dir, "probe.cu"), os.path.join(out_dir,
                                                               "probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    subprocess.run([nvcc, "-O3", "-arch=sm_90a", "-shared", "-Xcompiler",
                    "-fPIC", "-o", lib, src], check=True)
    probe = ctypes.CDLL(lib).probe_launch
    probe.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    probe.restype = ctypes.c_int
    i = np.arange(1, 9)
    f32 = np.float32
    # exact products just below 2^-126 that round to it, products equal to
    # a subnormal, and products just above; c shifts an add across the line
    a = np.concatenate([1 - i * 2.0 ** -23, 1 - i * 2.0 ** -24,
                        1 + i * 2.0 ** -23]).astype(f32)
    b = np.concatenate([2.0 ** -126 * (1 + i * 2.0 ** -23),
                        np.full(8, 2.0 ** -126),
                        np.full(8, 2.0 ** -126)]).astype(f32)
    c = np.concatenate([np.full(8, 0.0), -(2.0 ** -126 * (1 + i * 2.0 ** -23)),
                        np.full(8, 2.0 ** -149)]).astype(f32)
    ta, tb, tc = (torch.as_tensor(x, device="cuda") for x in (a, b, c))
    out = torch.empty(3 * len(a), dtype=torch.float32, device="cuda")
    err = probe(ta.data_ptr(), tb.data_ptr(), tc.data_ptr(), out.data_ptr(),
                len(a))
    if err:
        raise RuntimeError(f"probe_launch: CUDA error {err}")
    got = out.cpu().numpy().reshape(-1, 3)
    # after rounding: float64 holds these results exactly; c's 2^-149 is
    # read as zero (DAZ)
    cz = np.where(np.abs(c) < f32(2.0 ** -126), 0.0, c.astype(np.float64))
    a64 = a.astype(np.float64)
    want = np.stack([flushed(a64 * b), flushed(a64 * b + cz),
                     flushed(a64 + cz)], 1)
    before = np.stack([np.where(np.abs(a.astype(np.float64) * b)
                                < 2.0 ** -126, 0.0, want[:, 0])], 1)
    differ = int((got.view(np.int32) != want.view(np.int32)).sum())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({
        "cases": len(a), "differ_from_after_rounding": differ,
        "rounded_up_to_2^-126_kept": int((got[:8, 0] == f32(2.0 ** -126))
                                          .sum()),
        "before_rounding_would_give": before[:8, 0].tolist(),
        "mul": got[:, 0].tolist(), "fma": got[:, 1].tolist(),
        "add": got[:, 2].tolist()}))
    print(card)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
