"""float32 math rounded as the reference's compiled CPU program rounds it.

Plain PyTorch versions, for CPU tensors: ``kernels/refmath.py`` dispatches
by device and launches ``csrc/refmath.cu`` for a CUDA tensor, which runs
the same operations with every rounding written out.

What the reference computes at each site.  Read from its compiled CPU
program (jax 0.9.0, x86-64 with AVX-512 and FMA): the optimized HLO, the
LLVM IR after optimisation and the object code of each kernel
(``XLA_FLAGS=--xla_dump_to=<dir>``, ``objdump -dr``), on the package's own
jitted functions (``odometry_step`` default and time-continuous,
``register_and_verify_pairs``, ``_coral_impl``, ``logistic.fit``); glibc
2.36's ``libm.so.6`` read with ``objdump -d`` (ifunc resolvers, the
``__sinf_fma``/``__cosf_fma`` bodies, ``atanf``, ``__atan2f_finite`` and
their constant tables); then each emulation held bit-equal to the package's
own functions on the same inputs (``tests/test_torch_refmath.py``).

| Site (port) | What the reference's program does there | How it was read | Port |
| --- | --- | --- | --- |
| ``core/se2.py`` (compose, inverse, apply, rotate, rotmat); ``ops/registration.py`` ``_residual_terms``, ``motion_correct_cells``; ``ops/features.py::transform_cells``; ``ops/posegraph.py``; ``ops/radar.py::motion_compensate`` | ``llvm.sin``/``llvm.cos`` of one angle become one ``sincosf`` call in a fusion (``sinf``/``cosf`` in small programs): glibc's, whose ifunc picks ``__sinf_fma`` etc. here; all three give the same bits (300,000 values) | relocations of the kernels' object code; the resolvers and bodies in libm | :func:`sincos` |
| ``core/se2.py::wrap_angle`` | ``sincosf`` then ``atan2f`` in one fusion | object code (``cosine_atan2_fusion``) | :func:`wrap_angle` |
| ``ops/registration.py::cell_rel_timestamps``, ``ops/radar.py::motion_compensate``, ``ops/scancontext.py::_descriptor`` | ``atan2f``: fdlibm's float algorithm (the symbol has no ifunc: no FMA); then d / (2 pi) - 0.5 as ``vfmsub`` of d and 1 / (2 pi) | libm's ``atanf``/``__atan2f_finite``; the fusion's HLO and object code | :func:`atan2`, :func:`recip` |
| ``ops/coral.py`` entropy and KL ``log`` | XLA's inline float32 log (Eigen's ``plog``) | IR of ``wrapped_log`` and of the CorAl fusions | :func:`log` |
| ``ops/features.py`` planarity, ``ops/registration.py`` Cauchy and combined losses, ``ops/posegraph.py`` loop loss ``log1p`` | XLA's ``xla.log1p.f32``: a rational form below sqrt(2) - 1, else its log of x + 1 | IR of ``wrapped_log-plus-one`` | :func:`log1p` |
| ``ops/logistic.py`` sigmoid; ``exp`` of ``ops/scancontext.py::odometry_similarity``, ``models/strategies.py``, ``ops/cen.py`` | XLA's inline float32 exp (Eigen's ``pexp``); ``jax.nn.sigmoid`` is 1 / (exp(-z) + 1) in one fusion; a division by a constant is a product by its reciprocal | IR of ``wrapped_exponential`` and ``add_divide_fusion``; HLO | :func:`exp`, :func:`sigmoid`, :func:`recip` |
| every product feeding an add in the ported arithmetic (se2, CorAl, CFEAR cells, the LM's residuals, Jacobians and 3x3 solve, the motion corrections) | one ``vfmadd``/``vfmsub`` when the product has one use; of two such operands the first is fused; a two-term reduction is ``fma(second, second, first product)`` | object code of the fusions | :func:`fma` (kernel op ``fma`` on the card) |
| ``ops/registration.py`` LM step, theta - solve(H + damp, g) | the adjugate form of ``_solve3x3``, each difference of products fused, theta_i - s_i * (1 / det) one ``vfnmadd``; of x1's and x2's sums the b1 product is fused in the unbatched odometry step (scalar code), the b0 product in vmapped code, where x1 follows neither (``ROADMAP.md`` section 3) | object code of the step's ``negate_add_fusion``; the body compiled alone for one system (bit-equal, 3,000 systems) and vmapped (B = 2-64: x0 and x2 bit-equal) | :func:`lm_update` |
| ``ops/registration.py::sampled_covariance`` fit; ``ops/logistic.py`` xb @ w and the Hessian | the runtime's matrix kernel at the offline wave's shape (f32[10, 27] by f32[64, 27]) and at [5, n] by [5, n], and the emitted loop of xb @ w: one fused multiply-add a term in order from zero | HLO (``dot`` not fused), IR of ``dot_general.12_elemental``, the same ops compiled alone | :func:`dot` |
| ``sqrt`` of data: the P2D whitening, the robust losses, the CFEAR cell eigenvalues, Cen's and ScanContext's norms, the PGO weights | ``llvm.sqrt``: the IEEE square root (``vsqrtps``); torch's vectorised CPU sqrt is not (one ulp off in 0.65 % of values) | IR of the fusions; the reference's output against the float64 square root rounded | :func:`sqrt` |
| ``ops/registration.py::_rho_and_weight`` Huber and Cauchy | Huber: ``2 delta sqrt(s) - delta^2`` one ``vfmadd`` of sqrt(s) and the constants, ``delta / sqrt(s)`` one division (torch divides a number by a tensor as a reciprocal times the number); Cauchy: ``s / b`` a product by the reciprocal, fused into ``1 + s / b`` | HLO and IR of ``odometry_step``; the losses compiled alone, bit-equal | :func:`fma`, :func:`sqrt`, :func:`recip` |
| ``ops/registration.py::_chol2x2_inv_sqrt`` | ``a*c - b*b`` as ``fma(a, c, -(b*b))``; ``(-b / det) / u22`` rewritten by XLA to ``-b / (det * u22)``; ``ia - u12*u12`` as ``fma(-u12, u12, ia)`` | HLO of ``odometry_step`` (P2D), its IR; 196,608 matrices bit-equal | :func:`fma`, :func:`sqrt` |
| ``ops/registration.py::_rho_and_weight`` SoftLOne and Tukey | ``s / b`` a product by the float32 reciprocal, fused into ``1 + s / b`` (``vfmadd``) and ``1 - s / b`` (``vfnmadd``); ``u ** 3`` as ``u * (u * u)`` with ``1 - u^3`` one ``vfnmadd``; ``2 b`` and ``b / 3`` folded into constants | optimized HLO and object code of the losses compiled alone; 196,608 values bit-equal at loss limits 0.1, 0.3, 1, 2 | :func:`fma`, :func:`sqrt`, :func:`recip` |
| ``ops/registration.py::_prior_terms`` | ``sqrt_info @ (theta - guess)``, ``|pr|^2``, ``Jp^T Jp`` and ``Jp^T pr``: one fused multiply-add a term in order | the cost pass with a prior compiled alone, bit-equal on 256 priors | :func:`fma` |
| ``ops/logistic.py::gradient`` | xb^T (sw (p - y)): XLA's scalar loop with reassociable adds, vectorised by LLVM in an order that depends on n (:func:`loop_dot_shape`) | object code of ``copy_dot_fusion`` at n = 13-1287; the product compiled alone held bit-equal at every n from 1 to 700 and at 13 k up to 1,560 (4 and 7 outputs) | :func:`loop_dot` |
| ``ops/logistic.py::solve`` | ``jnp.linalg.solve`` of the fit's 4x4 / 7x7 system: jaxlib's ``lapack_sgetrf_ffi`` and two ``lapack_strsm_ffi`` (unit lower, then upper), which call SciPy's OpenBLAS (0.3.30, its SkylakeX kernels here), the right-hand side permuted by the pivots | optimized HLO of ``logistic.fit``; ``objdump -d`` of the library: ``sgetrf_single`` (unblocked below 2 x 4 columns), ``sgetf2_k``, ``sdot_k``, ``sgemv_n`` (its small-n path and its n = 4 remainders), the generic ``trsm_kernel_LT``/``_LN``, ``trsm_iunncopy`` and the ``sgemm_kernel`` update they call (its scalar edge: a fused multiply-add chain in k order, then c + alpha acc once); SciPy's factors and solves bit-equal on 63,000 systems, k = 1-7 (the fit's matrices, general, integer-valued with ties in magnitude, entries over e^+-30, zero pivots) | :func:`lu_solve` |
| ``ops/scancontext.py::_travel`` (``detect``'s travelled distance) | ``jnp.cumsum`` as XLA's reduce-window rewrite: rows of 16 summed in order from zero, the rows' totals scanned the same way (recursively), shifted by one row and added | optimized HLO of ``detect`` at capacities 256, 1000 and 4608 | :func:`blocked_cumsum` (kernel entry ``cumsum``) |
| ``ops/features.py`` the CFEAR weight sum | ``jnp.sum`` of a long row as XLA's CPU tree reduction: windows of 32 points (half the padding, rounded down, in front) summed in order from zero, recursively | optimized HLO of the masked row sum (and of ``_coral_impl``'s masked sums over the merged query slots) | :func:`tree_sum` (``csrc/cells.cu`` and ``csrc/coral_moments.cu``'s ``coral_tail`` on the card) |
| ``ops/registration.py::_covariance_from_fit`` | ``jnp.linalg.eigvalsh`` of the 3 x 3 Hessian: jaxlib's ``lapack_ssyevd_ffi`` with vectors (``ssytd2``'s reflector, then ``ssteqr``: implicit QL / QR, ``slartg``, ``slaev2``); the guarded ``jnp.linalg.inv``: ``sgetrf``, then ``strsm`` against the permuted identity | optimized HLO of the function; ``objdump -d`` of ``ssyevd_``, ``ssytd2_``, ``ssteqr_``, ``slartg_``, ``slae2_``/``slaev2_``, ``slapy2_`` (no fused multiply-add in the LAPACK) and the SkylakeX ``ssymv``/``sdot``/``saxpy``/``ssyr2`` kernels they call (fused); eigenvalues bit-equal on 20,000 symmetric matrices (convex, indefinite, near-singular, any scale), inverses on 20,000 | :func:`eigvalsh3`, :func:`inv3` (``csrc/refmath.cuh``'s ``la_eigvalsh3``, ``lu_factor``, ``lu_apply`` in the evaluation entry) |
| ``ops/registration.py::associate`` squared distances (argmin and radius gate) | fma(dy, dy, dx*dx) (the argmin's fusion), the offsets, product and sum flushed; the winner's attributes read through a one-hot product (a subnormal attribute is zero) | object code of the argmin fusion; the jitted ``associate`` on a radius between the two roundings | ``associate``, ``csrc/lm_solve.cu``'s ``sqdist`` |
| ``ops/coral.py::_kl_divergence_2d`` | tr(S1^-1 S0) a ``dot`` of the four products in order, each rounded; the Mahalanobis term two dots of fused multiply-adds from zero | optimized HLO of the function; its einsums compiled alone, bit-equal | written out (``csrc/coral_moments.cu``'s ``coral_tail`` alike) |
| ``ops/scancontext.py`` ring and sector keys (``context_descriptors``'s descriptors, ``detect``'s sector keys) | ``jnp.mean`` as XLA's tree reduction (windows of 32; the 40 rings padded 12 / 12, the 120 sectors 4 / 4), the sum times the float32 reciprocal of the count | optimized HLO of ``context_descriptors`` and ``detect``; 16,000 keys bit-equal | :func:`sc_key` (``csrc/scancontext.cu``'s ``sc_key_kernel``) |
| ``ops/scancontext.py::retrieve`` ring-key distance | each difference and square rounded and stored, the tree sum of the 40, then the odometry term fused: fma(10 sim, 10 sim, sum) | optimized HLO and object code of ``detect`` (``select_negate_fusion``: one ``vfmadd213ps``) | :func:`sc_ring_distance` (``sc_ring_distance_kernel``) |
| ``ops/scancontext.py::sc_distance`` (vmapped in ``retrieve``) | the sector keys' difference fma(vq_sum, 1 / R, -vc) (``vfmsub231ps``), its square rounded, the tree sum; the Gram matrix the runtime's matrix product, one fused multiply-add a ring in order from zero; the norms the IEEE root of the tree sum of rounded squares; the similarity a true division by max(qn cn, 1e-20), its tree sum divided by the effective count as a float | optimized HLO and object code of ``detect`` (``subtract_multiply_fusion``, ``divide_select_fusion``, ``broadcast_select_fusion.1``); the dot compiled alone at [5, 40, 120] x [5, 40, 1200], 720,000 entries bit-equal | :func:`sc_distance` (``sc_distance_kernel``, a block a pair) |
| ``ops/posegraph.py::measured_sqrt_info`` (eager calls) | 0.5 (cov + cov^T) + 1e-9 I; ``jnp.linalg.inv`` (``sgetrf``, ``strsm``, :func:`inv3`); the scale; ``jnp.linalg.cholesky``: the input symmetrised, jaxlib's ``lapack_spotrf_ffi`` (OpenBLAS's unblocked ``spotf2_L`` at n = 3: a_jj - ``sdot``, its root, the column a_ij - ``sgemv`` times 1 / l_jj), NaN where a pivot is not above zero | the calls' custom calls; OpenBLAS's ``potf2_L`` loop held bit-equal on 12,000 covariances (SPD at scales e^-12 to e^2, random-rank, singular, zero, negative definite, asymmetric) | :func:`measured_sqrt_info`, :func:`chol3` (``refmath.cu``'s ``refmath_sqrt_info_kernel``, ``refmath.cuh::chol3``) |
| subnormal operands and results of the functions above, of :func:`dot`, :func:`loop_dot`, :func:`lu_solve` and :func:`fma` (``vfmadd`` flushes; jaxlib runs the LAPACK on the same thread), and at the audited sites (CorAl's moment sums, covariance and KL inverse, the eigen gates and the cells' covariance, the association's distances and attributes, the registration residuals and the LM's products w J [J | r], PGO's residuals, Jacobian blocks, weights, gradient and Hessian blocks, the logistic fit's coefficients) | flushed to zero (the reference's threads run with DAZ and FTZ), a result where its rounding with an unbounded exponent is below 2^-126 (x86 detects tininess after rounding: an exact result in [2^-126 - 2^-150, 2^-126 - 2^-151), which gradual underflow rounds up to 2^-126, is flushed) | outputs on inputs driven into the subnormal range, against the package's own functions (``tests/test_torch_parity_faults.py``, the ``flush`` cases; the tie: ``tests/test_torch_parity_repairs.py``) | :func:`ftz`; products and fused multiply-adds by their exact result (:func:`_flush`: :func:`mul_ftz`, :func:`sum_ftz`, :func:`fma`) (kernel op ``ftz`` on the card; ``.ftz`` instructions ``mul_ftz``/``fma_ftz``/``ref_fma`` and ``daz`` in the kernels) |
| lone products (a multiply not fused into an add): PGO's weighted residual w r; the CFEAR cells' mu_0 mu_1, the eigen gate's lmax lmin and the normal's orientation n_0 (o - mean)_0; CorAl's c01 c10, the KL inverse's entries, its trace products and its Mahalanobis first products; the residuals' first products (s u_y, c u_y, n_0 e_0, n_1 dy, u_0 e_0, u_r0 dx) | ``vmulps`` on the FTZ / DAZ threads: the product flushed by its exact value (a product in the tie interval is 0, not 2^-126); a subnormal sine (``sinf`` returns a subnormal theta unchanged) read as zero | object code of the fusions; each driven into the tie against the package's functions (``tests/test_torch_parity_repairs.py``: ``test_flush_tie_in_lone_products``, ``test_flush_tie_in_residual_products``, the sine's case) | :func:`mul_ftz` (the refmath op :func:`mul` where PGO runs on the card: one launch); ``refmath.cuh``'s ``mul_ftz`` (mul.rn.ftz) in ``csrc/cells.cu``, ``coral_moments.cu``'s ``tail_det``/``tail_kl`` and ``lm_solve.cu``'s ``leaf`` |

The flush tie, product by product.  The products the port still writes
as ``ftz(a * b)`` (plain) or ``daz(__fmul_rn(a, b))`` (kernels) round
with gradual underflow and flush after: on the tie they give 2^-126 where
the reference gives 0.  None of them is on the tie in these cases:

- squares (PGO's r r, the cells' mu_i mu_i, d d, b b and v_0 v_0, the
  residuals' r_0 r_0, the gates' radius^2): no float32 square lies in the
  interval (with x = m 2^e, x^2 = 2^-126 (1 - d) needs m^2 in [2^48 -
  2^24, 2^48 - 2^23), and (2^24 - 1)^2 = 2^48 - 2^25 + 1 is under it;
  ``test_association_distances_never_reach_the_tie``);
- products by 2^k, k >= 0 (``2.0 * x`` of the sampled covariance's
  Hessian and inverse), by 1 or by 0 (P2D's Jacobian rows): exact, and a
  normal operand gives 2^-126 or more;
- XLA exp's scale y 2^n (a negative power: the tie needs y 2^n = 2^-126 -
  2^-150 exactly): every float32 x in [-88, -87] gives the reference's
  bits (``test_exp_scale_never_reaches_the_tie``);
- the KL score's half 0.5 (t + log(det1 / det0)): t = (trace + mahal) - 3
  is 0 or a multiple of 2^-23 at least, the log of a float32 ratio 0 or
  2^-25 at least, so their sum is never 2^-125 - 2^-149.

These could meet the tie, no case is built for them, and each keeps the
gradual rounding in plain and kernel alike (``ROADMAP.md`` section 3):
the halves of sums (the cells' 0.5 (k01 + k10) and the eigen gate's half
trace, reached only where the sum is +-(2^-125 - 2^-149)); the combined
loss's weight f' g' (a residual above about 1e18); jaxlib's LAPACK
products (``la_mul``, :func:`_mul`, :func:`lu_solve`'s scaled rows and
dot remainders, ``ceres_covariance``'s 30 x score and scale x inverse,
the sampled covariance's scale products), reached only with entries near
2^-63; and the association's normal-direction products, whose fused
sum waits for the LM's sums (``ROADMAP.md`` section 3 item 1).  The lone
products of se2's sites and of the association's world transform flush
by their exact value (``core/se2.py::_mul``, :func:`mul`;
``refmath.cuh::se2_rotated``, mul.rn.ftz), their sums flush their
operands and result (``core/se2.py::_add``, add.rn.ftz).

Fused multiply-adds inside the functions:

- exp: ``fma(x, log2e, 0.5)`` before the floor; ``r - n*C2`` fused (the
  ``n*C1`` product is exact); Horner steps ``fma(y, r, c)``; then
  ``fma(y, r*r, r)``; no fusion into the final scale by 2^n (exact).
- log: Horner steps ``fma(y, x, c)`` in three interleaved chains joined by
  ``fma(y, x3, y1)``, ``fma(y, x3, y2)``; the last product ``y*x3`` is fused
  into its add with ``e*C2`` (the first operand), ``x - 0.5*x2`` and
  ``+ e*C1`` have exact products.
- log1p's rational form: numerator and denominator Horner steps fused;
  ``-0.5*x2 + x3*(P/Q)``: the first operand (exact) is fused.
- ``__sinf_fma``/``__cosf_fma``: the reduction ``x - n*pi/2`` is one
  ``vfnmadd`` (emulated exactly, :func:`_reduce`); the polynomials are the
  FMA chains written out in :func:`_sin_poly` and :func:`_cos_poly`.
- ``atan2f``/``atanf``: float arithmetic, no fusion.

On the card the sites of the main path that combine these functions
(``core/se2.py``'s pose algebra, :func:`norm2`, registration's world-frame
targets, the motion compensation) are each one launch of
``csrc/refmath_sites.cu``, which runs the same operations.

What the reference computes otherwise and the port does not (yet) is in
``ROADMAP.md`` section 3: the sums over many terms (voxels, the LM's cost,
gradient and Hessian),
the fit at wave sizes other than 64, the LM solve's x1 in vmapped code,
the CFEAR eigen-decomposition's sqrt (bit-equal with :func:`sqrt`, left
at torch's while the LM's sums are not the reference's) and the
association's normal-direction sum (fused by the reference's ``associate``
compiled alone; left as two roundings while the LM's sums are not the
reference's).
"""
from __future__ import annotations

import functools
import math
import struct

import torch

_F32, _F64 = torch.float32, torch.float64
_MIN_NORM = 1.1754943508222875e-38  # 2^-126


def _f(bits: int) -> float:
    """The float32 with these bits, as a Python float."""
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _d(hexstr: str) -> float:
    return float.fromhex(hexstr)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The IEEE float32 square root (the reference's ``vsqrtps``), its
    subnormal operands flushed.  torch's vectorised CPU sqrt is not
    correctly rounded (AVX-512: 1,274 of 196,608 values in [0.001, 100]
    one ulp off); the float64 square root of a float32, rounded once to
    float32, is (53 >= 2 * 24 + 2 bits)."""
    return ftz(x.to(_F32)).to(_F64).sqrt().to(_F32)


def _two_sum(p: torch.Tensor, c: torch.Tensor):
    """(s, err) of float64 p + c: the rounded sum and its exact remainder,
    p + c = s + err exactly."""
    s = p + c
    bb = s - p
    return s, (p - (s - bb)) + (c - bb)


def _fused(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 of p + c for float64 p (an exact float32 product) and c
    (a float32), rounded once.

    The float64 sum is off the exact value by less than half its ulp and
    rounds to the same float32 unless it lies on a float32 tie (or in
    float32's subnormal range).  Those few are rounded to odd first (the
    exact remainder decides the last bit), which makes the float32 rounding
    the correctly rounded fused result.  A zero float64 sum is exact (a
    nonzero exact sum is a multiple of 2^-298, which float64 holds), so it
    is no tie."""
    s = p + c
    a = torch.abs(s)
    tie = ((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000) | \
        ((a < _MIN_NORM) & (a != 0))
    if bool(tie.any()):
        _, err = _two_sum(p, c)
        odd = (s.view(torch.int64) & 1) == 1
        fix = tie & (err != 0) & ~odd
        toward = torch.where(err > 0, torch.full_like(s, math.inf),
                             torch.full_like(s, -math.inf))
        s = torch.where(fix, torch.nextafter(s, toward), s)
    return s.to(_F32)


#: the exact results whose float32 rounding with an unbounded exponent is
#: below 2^-126 but whose rounding with gradual underflow is 2^-126: those
#: in [2^-126 - 2^-150, 2^-126 - 2^-151)
_TIE = 2.0 ** -126 - 2.0 ** -151


def _flush(r: torch.Tensor, exact) -> torch.Tensor:
    """The float32 result r of one operation (rounded with gradual
    underflow), flushed as the reference's FTZ threads and the card's
    ``.ftz`` instructions flush it: where the exact result rounded with an
    unbounded exponent is below 2^-126.  That differs from :func:`ftz` of r
    only where |r| = 2^-126 and |exact| < 2^-126 - 2^-151 (a product or a
    fused multiply-add; the exact sum of two float32 values is a multiple
    of 2^-149, never in that interval).  ``exact()`` gives (s, err), float64
    with s + err the exact result; on the CPU it is called only where some
    |r| = 2^-126, off the CPU always (asking would be a host sync)."""
    mag = torch.abs(r)
    if r.device.type == "cpu" and not _reaches_min_norm(mag):
        return r * torch.ge(mag, _MIN_NORM, out=mag)
    s, err = exact()
    a = torch.abs(s)
    below = (a < _TIE) | ((a == _TIE) & (err * s < 0))
    return ftz(torch.where((mag == _MIN_NORM) & below, r * 0.0, r))


def _reaches_min_norm(mag: torch.Tensor) -> bool:
    """Whether some of the magnitudes ``mag`` is 2^-126: the least
    |mag - 2^-126| is 0 (arithmetic and a reduction, cheaper on the CPU
    than a comparison over the tensor; a NaN among them asks exactly)."""
    if mag.numel() == 0:
        return False
    z = float(torch.abs(mag - _MIN_NORM).amin())
    return z == 0.0 or (z != z and bool(torch.eq(mag, _MIN_NORM).any()))


def _as64(x):
    return x.to(_F64) if isinstance(x, torch.Tensor) else x


def mul_ftz(a, b) -> torch.Tensor:
    """float32 a * b, its subnormal result flushed as the reference's FTZ
    threads (and ``refmath.cuh::mul_ftz``) flush it (:func:`_flush`); the
    operands are taken as given (flushed by the caller where the reference
    flushes them)."""
    return _flush(a * b, lambda: (_as64(a) * _as64(b), 0.0))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The refmath op ``mul``: a lone float32 product a * b as the
    reference's threads compute it (DAZ and FTZ) and the card's mul.rn.ftz:
    subnormal operands read as zero, the result flushed by its exact value
    (:func:`mul_ftz`); the operands broadcast together."""
    return mul_ftz(ftz(a), ftz(b))


def sum_ftz(p64: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """float32 of the float64 p64 (an exact product) plus the float32 acc,
    rounded from the float64 sum and flushed by the exact result
    (:func:`_flush`): a step of the CorAl moments' ordered sum of squares
    (``csrc/coral_moments.cu``'s ``fma_ftz``)."""
    a64 = acc.to(_F64)
    return _flush((p64 + a64).to(_F32), lambda: _two_sum(p64, a64))


def _fma_normal(a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c with a single rounding and no flush: the polynomial
    steps of :func:`exp`, :func:`log` and :func:`log1p`, whose operands
    and results are normal (their input flushed first), and the LM step
    :func:`lm_update`, as ``refmath.cuh`` computes them."""
    a, b, c = torch.broadcast_tensors(torch.as_tensor(a), torch.as_tensor(b),
                                      torch.as_tensor(c))
    return _fused(a.to(_F64) * b.to(_F64), c.to(_F64))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c with a single rounding (:func:`_fused`), subnormal
    operands counted as zero and a result below 2^-126 zero (the
    reference's threads run with DAZ and FTZ; :func:`_flush`): ``vfmadd``
    itself flushes, so every fused multiply-add of the reference's program
    does."""
    a, b, c = torch.broadcast_tensors(torch.as_tensor(a), torch.as_tensor(b),
                                      torch.as_tensor(c))
    a, b, c = a.to(_F32), b.to(_F32), c.to(_F32)
    # a subnormal operand is zero: the product times 0 where either factor
    # is below FLT_MIN (a zero or NaN stays itself, with its sign)
    p = a.to(_F64) * b.to(_F64) * torch.ge(
        torch.minimum(a.abs(), b.abs()), _MIN_NORM)
    c = c.to(_F64) * torch.ge(c.abs(), _MIN_NORM)
    return _flush(_fused(p, c), lambda: _two_sum(p, c))


def fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float64 a*b + c with a single rounding, for the finite operands of
    the C library's polynomials: the product split exactly into two
    doubles (Veltkamp/Dekker), the sum carried as a double-double."""
    split = 134217729.0  # 2^27 + 1
    t = a * split
    ah = t - (t - a)
    al = a - ah
    t = b * split
    bh = t - (t - b)
    bl = b - bh
    p = a * b
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    return s + (err + e)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _from_bits(i: torch.Tensor) -> torch.Tensor:
    return i.to(torch.int32).view(_F32)


def recip(c: float) -> float:
    """The float32 reciprocal of the float32 constant c: the reference's
    compiler turns a division by a constant into a multiplication by it
    (whose product may then be fused into an add)."""
    return float(torch.tensor(1.0, dtype=_F32) / torch.tensor(c, dtype=_F32))


def f32_ftz(x: float) -> float:
    """The float32 nearest x, zero where that is subnormal: a constant as
    the reference's threads read it (DAZ)."""
    v = float(torch.tensor(x, dtype=_F32))
    return v if abs(v) >= _MIN_NORM else 0.0 * v


def ftz(x: torch.Tensor) -> torch.Tensor:
    """The reference's threads run with denormals-are-zero and
    flush-to-zero: a subnormal operand or result of its float arithmetic
    is a signed zero (x times 0, which keeps a NaN).  The mask is written
    as 0 / 1 into |x|'s own buffer, so x is multiplied by its own dtype."""
    keep = torch.abs(x)
    return x * torch.ge(keep, _MIN_NORM, out=keep)


# ---- XLA's inline exp (Eigen pexp, float32) --------------------------------

_EXP_LO = _f(0xC2AF999A)  # -87.8000030517578
_EXP_HI = _f(0x42B1999A)  # 88.8000030517578
_LOG2E = _f(0x3FB8AA3B)
_C1 = 0.693359375
_C2 = _f(0xB95E8083)  # -2.12194440e-4
_EXP_P = [_f(0x39506967), _f(0x3AB743CE), _f(0x3C088908), _f(0x3D2AA9C1),
          _f(0x3E2AAAAA)]


def _clamp_nan(x, lo, hi):
    """The compiled min/max: a NaN passes through."""
    x = torch.where(x >= lo, x, torch.where(torch.isnan(x), x,
                                            torch.full_like(x, lo)))
    return torch.where(x <= hi, x, torch.where(torch.isnan(x), x,
                                               torch.full_like(x, hi)))


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 exp."""
    x = _clamp_nan(ftz(x.to(_F32)), _EXP_LO, _EXP_HI)
    one = torch.ones_like(x)
    fx = torch.floor(_fma_normal(x, one * _LOG2E, one * 0.5))
    fx = _clamp_nan(fx, -127.0, 127.0)
    r = x - fx * _C1
    r = _fma_normal(-fx, one * _C2, r)
    y = _fma_normal(r, one * _EXP_P[0], one * _EXP_P[1])
    for c in _EXP_P[2:] + [0.5]:
        y = _fma_normal(y, r, one * c)
    y = _fma_normal(y, r * r, r)
    y = y + 1.0
    n = torch.where(torch.isnan(fx), torch.zeros_like(fx), fx)
    scale = _from_bits((n.to(torch.int32) + 127) << 23)
    return ftz(y * scale)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as compiled: 1 / (exp(-x) + 1); the exp's last
    product, fused into the add, is exact."""
    return ftz(1.0 / (exp(-x.to(_F32)) + 1.0))


# ---- XLA's inline log (Eigen plog, float32) --------------------------------

_SQRTHF = _f(0x3F3504F3)
_LOG_P = [_f(0x3D9021BB), _f(0xBDEBD1B8), _f(0x3DEF251A), _f(0xBDFE5D4F),
          _f(0x3E11E9BF), _f(0xBE2AAE50), _f(0x3E4CCEAC), _f(0xBE7FFFFC),
          _f(0x3EAAAAAA)]


def _log_core(x: torch.Tensor) -> torch.Tensor:
    one = torch.ones_like(x)
    invalid = ~(x > 0)  # x <= 0 or NaN
    zero = x == 0
    inf = x == math.inf
    xc = torch.where(x > _MIN_NORM, x, one * _MIN_NORM)
    bx = _bits(xc)
    e = ((bx >> 23) & 0x1FF) - 127
    m = _from_bits((bx & 0x807FFFFF) | 0x3F000000)
    e = e.to(_F32) + 1.0
    small = m < _SQRTHF
    tmp = torch.where(small, m, torch.zeros_like(m))
    x1 = m - 1.0
    e = e - torch.where(small, one, torch.zeros_like(m))
    x = x1 + tmp
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma_normal(x, one * p[0], one * p[1])
    y1 = _fma_normal(x, one * p[3], one * p[4])
    y2 = _fma_normal(x, one * p[6], one * p[7])
    y = _fma_normal(y, x, one * p[2])
    y1 = _fma_normal(y1, x, one * p[5])
    y2 = _fma_normal(y2, x, one * p[8])
    y = _fma_normal(y, x3, y1)
    y = _fma_normal(y, x3, y2)
    y = _fma_normal(y, x3, e * _C2)
    y = (x - 0.5 * x2) + y
    y = y + e * _C1
    out = torch.where(invalid, torch.full_like(y, math.nan), y)
    out = torch.where(zero, torch.full_like(y, -math.inf), out)
    return torch.where(inf, torch.full_like(y, math.inf), out)


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log."""
    return _log_core(ftz(x.to(_F32)))


_L1P_Q = [_f(0x417101AD), _f(0x42A6185B), _f(0x435DC32D), _f(0x439A8CA3),
          _f(0x43586D8A), _f(0x42707982)]
_L1P_P = [_f(0x383DE04B), _f(0x3EFF40C5), _f(0x40D284FA), _f(0x41EF4B9C),
          _f(0x4273CC76), _f(0x426473AD), _f(0x41A05101)]
_L1P_SMALL = _f(0x3ED413CD)  # sqrt(2) - 1


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p: below sqrt(2) - 1 in magnitude
    x - x^2/2 + x^3 P(x)/Q(x), else its log of x + 1."""
    x = ftz(x.to(_F32))
    one = torch.ones_like(x)
    x2 = x * x
    z0 = x * 0.0
    q = z0 + 1.0
    for c in _L1P_Q:
        q = _fma_normal(q, x, one * c)
    p = z0 + _L1P_P[0]
    for c in _L1P_P[1:]:
        p = _fma_normal(p, x, one * c)
    r = (x * x2) * (p / q)
    small = x + _fma_normal(x2, one * -0.5, r)
    return torch.where(torch.abs(x) < _L1P_SMALL, small, _log_core(x + 1.0))


# ---- the C library's sinf / cosf / sincosf (glibc 2.36, FMA variant) ------

# __sincosf_table[0] of libm.so.6; table[1] negates c0..c4 and s1 is
# unchanged, as the quadrant's sign needs
_HPI_INV = _d("0x1.45f306dc9c883p+23")  # 2/pi * 2^24
_HPI = _d("0x1.921fb54442d18p+0")
# pi/2 split so that n * _HPI_HI is exact for |n| < 2^8
_HPI_HI = float.fromhex("0x1.921fb54442dp+0")
_HPI_LO = _HPI - _HPI_HI
_COS_C = [1.0, _d("-0x1.ffffffd0c621cp-2"), _d("0x1.55553e1068f19p-5"),
          _d("-0x1.6c087e89a359dp-10"), _d("0x1.99343027bf8c3p-16")]
_SIN_S = [_d("-0x1.555545995a603p-3"), _d("0x1.1107605230bc4p-7"),
          _d("-0x1.994eb3774cf24p-13")]
_PI63 = _d("0x1.921fb54442d18p-62")
_INV_PIO4 = [
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415,
    0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5,
    0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295,
    0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041]


def _mad(a, b, c):
    """a*b + c with two roundings: the fast stand-in for fma64."""
    return a * b + c


def _sin_poly(xs, x2, f=fma64):
    """Odd polynomial of x (quadrant sign applied; the s coefficients are
    the same in both tables)."""
    s1, s2, s3 = _SIN_S
    x3 = x2 * xs
    p = f(x2, torch.full_like(x2, s3), torch.full_like(x2, s2))
    x7 = x2 * x3
    s = f(x3, torch.full_like(x2, s1), xs)
    return f(p, x7, s)


def _cos_poly(x2, neg, f=fma64):
    """Even polynomial; table 1 (``neg``) has c0..c4 negated."""
    sg = torch.where(neg, -torch.ones_like(x2), torch.ones_like(x2))
    c0, c1, c2, c3, c4 = (sg * c for c in _COS_C)
    x4 = x2 * x2
    c1p = f(x2, c1, c0)
    c2p = f(x2, c4, c3)
    x6 = x2 * x4
    c = f(x4, c2, c1p)
    return f(c2p, x6, c)


def _to_f32_near_ties(fast, exact):
    """fast() rounded to float32, where its double result lies too near a
    float32 rounding tie for the unfused steps to be trusted, exact()
    instead (both give doubles of one shape).  The fused and unfused
    polynomials differ by a few double ulps, so only values within 2^10
    double ulps of a tie can round otherwise: about 4e-6 of them."""
    d = fast()
    low = d.view(torch.int64) & 0x1FFFFFFF
    near = torch.abs(low - 0x10000000) < 1024
    if bool(near.any()):
        d = torch.where(near, exact(), d)
    return d.to(_F32)


def _reduce(y: torch.Tensor):
    """(r, n, sign index) with r = x - n*pi/2 for |x| < 120 (the fused
    subtraction, exact here: n*_HPI_HI and its subtraction are exact) and
    the integer reduction by 4/pi's bits above it."""
    x = y.to(_F64)
    n_fast = (((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24)
    nf = n_fast.to(_F64)
    r_fast = (x - nf * _HPI_HI) - nf * _HPI_LO
    large = torch.abs(y) >= 120.0
    if not bool(large.any()):
        return r_fast, n_fast, n_fast
    # large: glibc's reduce_large on the float's bits, in wrapping int64
    xi = _bits(y.to(_F32)).to(torch.int64) & 0xFFFFFFFF
    tab = torch.tensor(_INV_PIO4, dtype=torch.int64, device=y.device)
    idx = (xi >> 26) & 15
    shift = (xi >> 23) & 7
    m = ((xi & 0xFFFFFF) | 0x800000) << shift
    res0 = (m * tab[idx]) & 0xFFFFFFFF
    res1 = m * tab[idx + 4]
    res2 = m * tab[idx + 8]
    res0 = ((res2 >> 32) & 0xFFFFFFFF) | (res0 << 32)
    res0 = res0 + res1
    n_large = ((res0 + (1 << 61)) >> 62) & 3
    res0 = res0 - (n_large << 62)
    r_large = res0.to(_F64) * _PI63
    sign = (xi >> 31).to(torch.int32)
    n = torch.where(large, n_large.to(torch.int32), n_fast)
    r = torch.where(large, r_large, r_fast)
    q = torch.where(large, n + sign, n)  # sign-table index
    return r, n, q


_TAB_SIGN = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=_F64)


def sincos(y: torch.Tensor):
    """(sinf(y), cosf(y)) of the C library, as its sinf, cosf and sincosf
    give them."""
    y = y.to(_F32)
    x = y.to(_F64)
    a = torch.abs(y)
    small = (_bits(a) >> 20) < (0x3F490FDB >> 20)  # |y| < pi/4
    tiny = (_bits(a) >> 20) < (0x39800000 >> 20)  # |y| < 2^-12
    finite = torch.isfinite(y)
    r, n, q = _reduce(y)
    r = torch.where(small, x, r)
    n = torch.where(small, torch.zeros_like(n), n)
    q = torch.where(small, torch.zeros_like(q), q)
    x2 = r * r
    sgn = _TAB_SIGN.to(y.device)[q & 3]
    neg = (q & 2) != 0
    xs = r * sgn
    sp = _to_f32_near_ties(lambda: _sin_poly(xs, x2, _mad),
                           lambda: _sin_poly(xs, x2))
    cp = _to_f32_near_ties(lambda: _cos_poly(x2, neg, _mad),
                           lambda: _cos_poly(x2, neg))
    odd = (n & 1) == 1
    nan = torch.full_like(y, math.nan)
    s = torch.where(small & tiny, y, torch.where(odd, cp, sp))
    c = torch.where(small & tiny, torch.ones_like(y), torch.where(odd, sp, cp))
    return torch.where(finite, s, nan), torch.where(finite, c, nan)


# ---- the C library's atan2f (fdlibm's float algorithm, no FMA) ------------

_ATANHI = [_f(0x3EED6338), _f(0x3F490FDA), _f(0x3F7B985E), _f(0x3FC90FDA)]
_ATANLO = [_f(0x31AC3769), _f(0x33222168), _f(0x33140FB4), _f(0x33A22168)]
_AT = [_f(0x3EAAAAAB), _f(0xBE4CCCCD), _f(0x3E124925), _f(0xBDE38E38),
       _f(0x3DBA2E6E), _f(0xBD9D8795), _f(0x3D886B35), _f(0xBD6EF16B),
       _f(0x3D4BDA59), _f(0xBD15A221), _f(0x3C8569D7)]
_PI_O_4 = _f(0x3F490FDB)
_PI_O_2 = _f(0x3FC90FDB)
_PI = _f(0x40490FDB)
_PI_LO = _f(0xB3BBBD2E)
_TINY = _f(0x0DA24260)  # 1.0e-30


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """glibc's atanf for finite |x| < 2^25 and the |x| >= 2^25 limit."""
    hx = _bits(x)
    ix = hx & 0x7FFFFFFF
    ax = torch.abs(x)
    one = torch.ones_like(x)
    t0 = (2.0 * ax - 1.0) / (2.0 + ax)
    t1 = (ax - 1.0) / (ax + 1.0)
    t2 = (ax - 1.5) / (1.0 + 1.5 * ax)
    t3 = -1.0 / ax
    idv = torch.where(ix < 0x3F300000, 0, torch.where(
        ix < 0x3F980000, 1, torch.where(ix < 0x401C0000, 2, 3)))
    red = ix >= 0x3EE00000
    t = torch.where(idv == 0, t0, torch.where(idv == 1, t1, torch.where(
        idv == 2, t2, t3)))
    t = torch.where(red, t, x)
    z = t * t
    w = z * z
    a = _AT
    s1 = one * a[10]
    for c in (a[8], a[6], a[4], a[2], a[0]):
        s1 = c + w * s1
    s1 = z * s1
    s2 = one * a[9]
    for c in (a[7], a[5], a[3], a[1]):
        s2 = c + w * s2
    s2 = w * s2
    hi = torch.tensor(_ATANHI, dtype=_F32, device=x.device)[idv]
    lo = torch.tensor(_ATANLO, dtype=_F32, device=x.device)[idv]
    zr = hi - ((t * (s1 + s2) - lo) - t)
    zr = torch.where(hx < 0, -zr, zr)
    out = torch.where(red, zr, t - t * (s1 + s2))
    out = torch.where(ix < 0x31000000, x, out)
    big = (_ATANHI[3] + _ATANLO[3]) * one
    out = torch.where(ix >= 0x4C000000, torch.where(hx > 0, big, -big), out)
    return torch.where(ix > 0x7F800000, x + x, out)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The C library's atan2f."""
    y, x = torch.broadcast_tensors(y.to(_F32), x.to(_F32))
    hx, hy = _bits(x), _bits(y)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    one = torch.ones_like(x)
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)
    k = (iy - ix) >> 23
    q = ftz(torch.abs(ftz(y) / ftz(x)))
    z = _atanf(torch.where(k > 60, one, q))
    z = torch.where(k > 60, one * (_PI_O_2 + 0.5 * _PI_LO), z)
    z = torch.where((hx < 0) & (k < -60) & (k <= 60), torch.zeros_like(z), z)
    zneg = _from_bits(_bits(z) ^ -0x80000000)
    out = torch.where(m == 0, z, torch.where(
        m == 1, zneg, torch.where(m == 2, _PI - (z - _PI_LO),
                                  (z - _PI_LO) - _PI)))
    # x = 1: atanf(y)
    out = torch.where(hx == 0x3F800000, _atanf(y), out)
    # x or y infinite
    ypi2 = torch.where(hy < 0, one * (-_PI_O_2 - _TINY), one * (_PI_O_2 +
                                                                _TINY))
    out = torch.where(iy == 0x7F800000, ypi2, out)
    xinf_yinf = torch.stack([one * (_PI_O_4 + _TINY), one * (-_PI_O_4 - _TINY),
                             one * (3.0 * _PI_O_4 + _TINY),
                             one * (-3.0 * _PI_O_4 - _TINY)])
    xinf = torch.stack([one * 0.0, one * -0.0, one * (_PI + _TINY),
                        one * (-_PI - _TINY)])
    sel = m.long()[None]
    out = torch.where((ix == 0x7F800000) & (iy == 0x7F800000),
                      xinf_yinf.gather(0, sel)[0], out)
    out = torch.where((ix == 0x7F800000) & (iy != 0x7F800000),
                      xinf.gather(0, sel)[0], out)
    # x = 0, then y = 0
    out = torch.where(ix == 0, ypi2, out)
    yzero = torch.stack([y, y, one * (_PI + _TINY), one * (-_PI - _TINY)])
    out = torch.where(iy == 0, yzero.gather(0, sel)[0], out)
    return torch.where((ix > 0x7F800000) | (iy > 0x7F800000), x + y, out)


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """atan2f(sinf(t), cosf(t)), the reference's angle wrap."""
    s, c = sincos(theta)
    return atan2(s, c)


def norm2(v: torch.Tensor) -> torch.Tensor:
    """The length of [..., 2] vectors as the reference's program computes
    ``jnp.linalg.norm`` over two values: sqrt(fma(y, y, x * x)) with the
    IEEE root (the refmath site ``norm2``)."""
    return sqrt(fma(v[..., 1], v[..., 1], v[..., 0] * v[..., 0]))


@functools.lru_cache(maxsize=None)
def motion_constants():
    """The float32 constants of ``ops/radar.py::motion_compensate``: 1 /
    (2 pi) as the reference's program rounds the division's reciprocal, 2 pi
    and 1e-5 as torch rounds a Python float against a float32 tensor."""
    f32 = lambda c: float(torch.tensor(c, dtype=_F32))
    return recip(2.0 * math.pi), f32(2.0 * math.pi), f32(1e-5)


#: row length of the reference's blocked prefix sum
CUMSUM_BLOCK = 16


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of a float32 vector as the reference's compiled
    ``jnp.cumsum`` adds them.  Its optimized HLO (jax 0.9.0, CPU; ``detect``
    at capacities 256, 1000 and 4608) is XLA's reduce-window rewrite: the
    vector padded with zeros to rows of 16, each row summed in order from
    zero (a 1 x 16 reduce-window), the rows' totals scanned the same way
    (recursively while there are more than 16), shifted by one (the sum of
    the rows before each row, zero for the first) and added to each row's
    sums; 16 values or fewer are summed in order from zero.  torch.cumsum
    adds in another order (in float64 on the CPU)."""
    n = x.shape[0]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if n <= CUMSUM_BLOCK:
        out, acc = torch.empty_like(x), zero
        for i in range(n):
            acc = acc + x[i]
            out[i] = acc
        return out
    rows = -(-n // CUMSUM_BLOCK)
    xr = torch.cat([x, x.new_zeros(rows * CUMSUM_BLOCK - n)]).reshape(
        rows, CUMSUM_BLOCK)
    inner, acc = torch.empty_like(xr), zero.expand(rows)
    for j in range(CUMSUM_BLOCK):
        acc = acc + xr[:, j]
        inner[:, j] = acc
    before = torch.cat([zero[None], blocked_cumsum(acc)[:-1]])
    return (inner + before[:, None]).reshape(-1)[:n]


#: window of the reference's tree reduction (XLA's CPU tree-reduction
#: rewrite of a long row sum)
TREE_WINDOW = 32


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """sum over the last axis as the reference's compiled ``jnp.sum`` of a
    long row adds (its optimized HLO, jax 0.9.0 CPU: reduce-windows of 32
    with stride 32, the row padded with zeros to a multiple of 32, half the
    padding (rounded down) in front, each window summed in order from zero,
    the windows' sums reduced the same way until at most 32 are left, which
    are summed in order from zero): the CFEAR weight sum and CorAl's masked
    entropy sums over a pair's merged query slots."""
    n = x.shape[-1]
    if n <= TREE_WINDOW:
        acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for k in range(n):
            acc = acc + x[..., k]
        return acc
    m = -(-n // TREE_WINDOW)
    pad = m * TREE_WINDOW - n
    xp = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2)).reshape(
        x.shape[:-1] + (m, TREE_WINDOW))
    acc = torch.zeros(xp.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(TREE_WINDOW):
        acc = acc + xp[..., k]
    return tree_sum(acc)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[..., c] = sum_k a[..., k] * b[c, k] in float32, one fused
    multiply-add a term in k order from zero, so every row is rounded alike
    whatever the number of rows; subnormal operands and each step's
    subnormal result flushed, as the reference's threads flush them."""
    a, b = ftz(a), ftz(b)
    out = torch.zeros(a.shape[:-1] + b.shape[:1], dtype=_F32, device=a.device)
    for k in range(a.shape[-1]):
        out = fma(a[..., k:k + 1], b[:, k], out)
    return out


def loop_dot_shape(n: int):
    """(mode, interleave, epilogue width) of the loop in which the
    reference's program adds the n terms of a row of xb^T v (the logistic
    gradient's ``copy_dot_fusion``: XLA emits a scalar loop whose adds may
    be reassociated, LLVM vectorises it), read from its object code and
    held bit for bit at every n from 1 to 700 (``tests/test_torch_refmath
    .py``).  n <= 49: the rows are vectorised across the outputs, each row
    one fused multiply-add a term in order ("in_order").  Above, 8-lane
    chunks in ``interleave`` accumulators (2 up to n = 64, then 4), each
    pass taking 8 x interleave terms, (n - 1) // (8 x interleave) passes;
    up to 10 passes the loop is unrolled and its chunks reassociated into
    one chain ("unrolled"), above that the accumulators are summed in order
    after the loop ("loop"); then the 8 lanes in a halving tree, an
    epilogue loop of ``epilogue``-lane chunks (0: none) seeded with that
    sum and reduced the same way, and the last terms one at a time."""
    if n <= 49:
        return "in_order", 0, 0
    ic = 2 if n <= 64 else 4
    passes = (n - 1) // (8 * ic)
    rem = n - 8 * ic * passes
    if rem == 8 * ic or rem in (1, 2, 4, 8):
        vf = 0
    elif rem < 8:
        vf = {3: 2, 5: 4, 6: 2, 7: 2}[rem]
    else:
        vf = 8 if rem % 8 < 4 else 4
    return ("unrolled" if passes <= 10 else "loop"), ic, vf


def loop_chunk_order(passes: int, ic: int):
    """The order in which the unrolled loop's 8-lane chunks enter its one
    chain: the first accumulator's chunks, then each other accumulator's
    second chunk, its first, and the rest."""
    order = list(range(0, ic * passes, ic))
    for j in range(1, ic):
        seq = [ic * i + j for i in range(passes)]
        order += seq[1::-1] + seq[2:] if passes >= 2 else seq
    return order


def _lane_tree(a: torch.Tensor) -> torch.Tensor:
    while a.shape[-1] > 1:
        h = a.shape[-1] // 2
        a = ftz(a[..., :h] + a[..., h:])
    return a[..., 0]


def loop_dot(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out[c] = sum_k x[c, k] v[k] for x [K, n], v [n] in float32, added as
    the reference's vectorised loop adds the terms of the logistic
    gradient xb^T (sw (p - y)) (:func:`loop_dot_shape`), subnormal
    operands and results flushed."""
    x, v = ftz(x), ftz(v)
    k_rows, n = x.shape
    mode, ic, vf = loop_dot_shape(n)
    zeros = lambda w: torch.zeros((k_rows, w), dtype=_F32, device=x.device)
    if mode == "in_order":
        acc = zeros(1)[:, 0]
        for k in range(n):
            acc = fma(x[:, k], v[k].expand(k_rows), acc)
        return acc
    passes = (n - 1) // (8 * ic)

    def chunk(c, width=8, at=0):
        lo = at + width * c
        return x[:, lo:lo + width], v[lo:lo + width].expand(k_rows, width)

    if mode == "unrolled":
        acc = zeros(8)
        for c in loop_chunk_order(passes, ic):
            acc = fma(*chunk(c), acc)
    else:
        accs = []
        for j in range(ic):
            a = zeros(8)
            for i in range(passes):
                a = fma(*chunk(ic * i + j), a)
            accs.append(a)
        acc = accs[0]
        for a in accs[1:]:
            acc = ftz(acc + a)
    s = _lane_tree(acc)
    done = 8 * ic * passes
    m = (n - done - 1) // vf if vf else 0
    if m:
        e = torch.cat([s[:, None], zeros(vf - 1)], 1)
        for i in range(m):
            e = fma(*chunk(i, vf, done), e)
        s = _lane_tree(e)
        done += vf * m
    for k in range(done, n):
        s = fma(x[:, k], v[k].expand(k_rows), s)
    return s


def lm_update(theta: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              one_system: bool = False) -> torch.Tensor:
    """theta - a^{-1} b for [..., 3], [..., 3, 3] and [..., 3] in float32:
    the LM step of the reference's closed form (adjugate / Cramer,
    ``_solve3x3``) with its roundings.  Each p q - r t and the determinant's
    sums fused as written; each theta_i - s_i / det is one fused
    multiply-add of s_i and the reciprocal; of x1's and x2's sums the b1
    product is fused where the reference solves one system (its unbatched
    odometry step, scalar code: ``one_system``), the b0 product where it
    solves a batch (vectorised code; there x1 is not always its bits)."""
    # not flushed: its inputs are sums of normal products (csrc's lm_update3
    # alike)
    fma = _fma_normal
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    a20, a21, a22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]

    def cof(p, q, r, t):  # p q - r t
        return fma(p, q, -(r * t))

    c00, c01, c02 = cof(a11, a22, a12, a21), cof(a12, a20, a10, a22), \
        cof(a10, a21, a11, a20)
    det = fma(a02, c02, fma(a00, c00, a01 * c01))
    tiny = torch.where(det < 0, torch.full_like(det, -1e-30),
                       torch.full_like(det, 1e-30))
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, tiny, det)
    c10, c11, c12 = cof(a02, a21, a01, a22), cof(a00, a22, a02, a20), \
        cof(a01, a20, a00, a21)
    c20, c21, c22 = cof(a01, a12, a02, a11), cof(a02, a10, a00, a12), \
        cof(a00, a11, a01, a10)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]

    def pair(c0, c1):  # c0 b0 + c1 b1, one product fused
        return fma(c1, b1, c0 * b0) if one_system else fma(c0, b0, c1 * b1)

    s = (fma(c20, b2, fma(c00, b0, c10 * b1)), fma(c21, b2, pair(c01, c11)),
         fma(c22, b2, pair(c02, c12)))
    return torch.stack([fma(-inv_det, si, theta[..., i])
                        for i, si in enumerate(s)], -1)


#: the largest system :func:`lu_solve` takes: above it the BLAS kernels
#: the reference calls switch to blocked paths that are not written out
LU_SOLVE_MAX_K = 7


def _swap(x: torch.Tensor, i: int, p: torch.Tensor) -> torch.Tensor:
    """x with entries i and p[n] of each row n (x [N, K, ...]) exchanged."""
    idx = p.view(-1, 1, *([1] * (x.dim() - 2))).expand(-1, 1, *x.shape[2:])
    xi, xp = x[:, i:i + 1].clone(), x.gather(1, idx)
    x = x.clone()
    x[:, i:i + 1] = xp
    return x.scatter(1, idx, xi)


def _strided_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """OpenBLAS's ``sdot`` (SkylakeX kernel) of rows x, y [N, n] with x
    strided: pairs ``fma(x0, y0, x1 * y1)`` added into a float64
    accumulator from zero, an odd last product added alone, the sum
    rounded to float32 once; each float32 result flushed (FTZ)."""
    n = x.shape[1]
    acc = torch.zeros(x.shape[0], dtype=_F64, device=x.device)
    for p in range(0, n - 1, 2):
        acc = acc + fma(x[:, p], y[:, p], x[:, p + 1] * y[:, p + 1]).to(_F64)
    if n % 2:
        acc = acc + ftz(x[:, n - 1] * y[:, n - 1]).to(_F64)
    return ftz(acc.to(_F32))


def _chain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_k a[:, r, k] x[:, k] for a [N, R, n], x [N, n]: one fused
    multiply-add a term in k order from zero (the ``sgemv_n`` and
    ``sgemm`` kernels at these shapes), each result flushed (FTZ)."""
    acc = torch.zeros(a.shape[:2], dtype=_F32, device=a.device)
    for k in range(a.shape[2]):
        acc = fma(a[:, :, k], x[:, k:k + 1], acc)
    return acc


def lu_solve(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """h^{-1} g for float32 h [..., K, K], g [..., K], K <= 7, rounded as
    the reference's ``jnp.linalg.solve`` on the CPU: jaxlib calls SciPy's
    OpenBLAS (0.3.30, SkylakeX kernels), ``sgetrf`` then g permuted by its
    pivots, then ``strsm`` on the unit lower and on the upper factor.  Read
    from the library's object code: ``sgetrf_single`` takes the unblocked
    ``sgetf2_k`` at these sizes, a left-looking LU whose column j is
    brought up to date by ``sdot`` (:func:`_strided_dot`) for rows 1..j-1
    and ``sgemv_n`` (:func:`_chain`, y - acc rounded once) below; the
    pivot is the first largest magnitude; a pivot that is zero or below
    FLT_MIN leaves the rows unswapped and unscaled; the column under the
    pivot is multiplied by 1 / pivot.  ``strsm`` runs the generic
    ``trsm_kernel_LT`` / ``_LN``: the rows in blocks of 4, 2, 1 (from the
    top for the lower factor, of 1, 2, 4 from the bottom for the upper), a
    block first reduced by the solved rows (:func:`_chain`), then solved
    row by row, x_i = c_i * (1 / u_ii) and each later c_k - x_i a_ki one
    fused multiply-add.  jaxlib calls the library on the thread that runs
    the reference's program, whose subnormals are flushed (DAZ and FTZ): a
    subnormal entry of h or g is zero to every comparison and operation
    (the pivot search included), and every subnormal result is zero."""
    k = h.shape[-1]
    if h.shape[-2:] != (k, k) or g.shape != h.shape[:-1] or \
            not 1 <= k <= LU_SOLVE_MAX_K:
        raise ValueError(f"refmath.lu_solve: shapes {tuple(h.shape)}, "
                         f"{tuple(g.shape)} (K <= {LU_SOLVE_MAX_K})")
    lead = g.shape[:-1]
    a = ftz(h.reshape(-1, k, k).to(_F32))
    n = a.shape[0]
    piv = []
    one = torch.ones((), dtype=_F32, device=h.device)
    for j in range(k):
        col = a[:, :, j]
        for i in range(j):
            col = _swap(col, i, piv[i])
        for i in range(1, j):
            col = col.clone()
            col[:, i] = ftz(col[:, i] - _strided_dot(a[:, i, :i],
                                                      col[:, :i]))
        if j:
            col = torch.cat([col[:, :j], ftz(col[:, j:] - _chain(
                a[:, j:, :j], col[:, :j]))], 1)
        a = a.clone()
        a[:, :, j] = col
        p = j + torch.argmax(col[:, j:].abs(), 1)
        piv.append(p)
        t = col.gather(1, p[:, None])[:, 0]
        ok = (t != 0) & (t.abs() >= _MIN_NORM)
        swapped = _swap(a[:, :, :j + 1], j, p)
        a = torch.cat([torch.where(ok[:, None, None], swapped,
                                   a[:, :, :j + 1]), a[:, :, j + 1:]], 2)
        if j + 1 < k:
            below = a[:, j + 1:, j]
            a[:, j + 1:, j] = torch.where(
                ok[:, None], ftz(below * ftz(one / t)[:, None]), below)
    x = ftz(g.reshape(n, k).to(_F32))
    for i in range(k):
        x = _swap(x, i, piv[i])
    blocks, r0 = [], 0
    for w in (4, 2, 1):
        if k & w:
            blocks.append((r0, r0 + w))
            r0 += w
    for s, e in blocks:  # the unit lower factor, from the top
        if s:
            x = torch.cat([x[:, :s], ftz(x[:, s:e] - _chain(a[:, s:e, :s],
                                                             x[:, :s])),
                           x[:, e:]], 1)
        for i in range(s, e):
            x = x.clone()
            x[:, i + 1:e] = fma(-x[:, i:i + 1], a[:, i + 1:e, i],
                                x[:, i + 1:e])
    for s, e in blocks[::-1]:  # the upper factor, from the bottom
        if e < k:
            x = torch.cat([x[:, :s], ftz(x[:, s:e] - _chain(a[:, s:e, e:],
                                                             x[:, e:])),
                           x[:, e:]], 1)
        for i in range(e - 1, s - 1, -1):
            x = x.clone()
            x[:, i] = ftz(x[:, i] * ftz(one / a[:, i, i]))
            x[:, s:i] = fma(-x[:, i:i + 1], a[:, s:i, i], x[:, s:i])
    return x.reshape(lead + (k,))


# ---- the 3 x 3 symmetric eigenvalues and inverse of jaxlib's LAPACK -------
#
# ``sampled_covariance``'s convexity is ``jnp.all(jnp.linalg.eigvalsh(h) >
# 0)`` and its guarded inverse ``jnp.linalg.inv``.  On the CPU jaxlib calls
# SciPy's OpenBLAS 0.3.30 (LAPACK 3.12, SkylakeX kernels) for both, on the
# reference's thread (DAZ and FTZ): ``lapack_ssyevd_ffi`` with eigenvectors
# (eigvalsh is eigh's values), and ``lapack_sgetrf_ffi`` then two
# ``lapack_strsm_ffi`` against the permuted identity (:func:`lu_solve`, a
# right-hand side a column).  At n = 3 ``ssyevd`` runs ``ssytrd``'s
# unblocked ``ssytd2`` (one Householder reflector) and, through ``sstedc``
# (n below its divide size), ``ssteqr``: implicit QL or QR with
# ``slartg`` rotations, ``slaev2`` on 2 x 2 blocks.  Read from the
# library's object code (``objdump -d``): the LAPACK routines are compiled
# without fused multiply-adds and evaluate in source order; the BLAS calls
# of ``ssytd2`` are the SkylakeX C kernels, whose loops fuse
# (``ssymv_L``'s y += temp1 a and temp2 += a x, ``saxpy``'s y += da x and
# ``ssyr2``'s two ``saxpy`` a column); ``sdot`` of the two-vector is
# fma(y0, x0, y1 x1).  Every operation's subnormal result is flushed.
# Held bit for bit against ``jnp.linalg.eigvalsh`` and ``jnp.linalg.inv``
# (``tests/test_torch_evaluate.py``).

_LA_EPS = 2.0 ** -24            # slamch('E')
_LA_EPS2 = 2.0 ** -48
_LA_SAFMIN = 2.0 ** -126        # slamch('S')
_LA_SAFMAX = 2.0 ** 126
_LA_SSFMAX = float(torch.tensor(2.0 ** 63, dtype=_F32) / 3.0)
_LA_SSFMIN = 2.0 ** -15         # sqrt(safmin) / eps^2
_LA_RTMIN = 2.0 ** -63          # slartg's sqrt(safmin)
_LA_RTMAX = float(torch.tensor(2.0 ** 125, dtype=_F64).sqrt().to(_F32))
_LA_RMIN = float(torch.tensor(2.0 ** -103, dtype=_F64).sqrt().to(_F32))
_LA_RMAX = float(torch.tensor(2.0 ** 103, dtype=_F64).sqrt().to(_F32))
_LA_FLTMAX = float(torch.finfo(_F32).max)
_LA_SQRT2 = float(torch.tensor(2.0, dtype=_F64).sqrt().to(_F32))


def _mul(a, b):
    return ftz(a * b)


def _div(a, b):
    return ftz(a / b)


def _add(a, b):
    return ftz(a + b)


def _sub(a, b):
    return ftz(a - b)


def _slapy2(x, y):
    """sqrt(x^2 + y^2) as ``slapy2``: max * sqrt(1 + (min / max)^2), the
    larger magnitude where the smaller is 0 (or the larger overflows); a
    NaN passes (y's first)."""
    ax, ay = x.abs(), y.abs()
    w, z = torch.maximum(ax, ay), torch.minimum(ax, ay)
    q = _div(z, w)
    r = torch.where((z == 0) | (w > _LA_FLTMAX), w,
                    _mul(w, sqrt(_add(1.0, _mul(q, q)))))
    return torch.where(torch.isnan(y), y, torch.where(torch.isnan(x), x, r))


def _slae2(a, b, c):
    """The eigenvalues (rt1, rt2) of [[a, b], [b, c]] as ``slae2`` (and
    ``slaev2``, whose values are the same operations)."""
    sm, df = _add(a, c), _sub(a, c)
    adf, ab = df.abs(), _add(b, b).abs()
    big = a.abs() > c.abs()
    acmx, acmn = torch.where(big, a, c), torch.where(big, c, a)
    qa, qb = _div(ab, adf), _div(adf, ab)
    rt = torch.where(adf > ab, _mul(adf, sqrt(_add(1.0, _mul(qa, qa)))),
                     torch.where(adf < ab,
                                 _mul(ab, sqrt(_add(1.0, _mul(qb, qb)))),
                                 _mul(ab, torch.full_like(ab, _LA_SQRT2))))
    rt1 = torch.where(sm < 0, _mul(0.5, _sub(sm, rt)),
                      torch.where(sm > 0, _mul(0.5, _add(sm, rt)),
                                  _mul(0.5, rt)))
    rt2 = torch.where((sm < 0) | (sm > 0), _sub(_mul(_div(acmx, rt1), acmn),
                                    _mul(_div(b, rt1), b)),
                      _mul(-0.5, rt))
    return rt1, rt2


def _slartg(f, g):
    """The plane rotation (c, s, r) of ``slartg`` (LAPACK 3.12)."""
    f1, g1 = f.abs(), g.abs()
    one, zero = torch.ones_like(f), torch.zeros_like(f)
    safe = (f1 > _LA_RTMIN) & (f1 < _LA_RTMAX) & (g1 > _LA_RTMIN) & \
        (g1 < _LA_RTMAX)
    d = sqrt(_add(_mul(f, f), _mul(g, g)))
    u = torch.clamp(torch.maximum(torch.clamp(f1, min=_LA_SAFMIN), g1),
                    max=_LA_SAFMAX)
    fs, gs = _div(f, u), _div(g, u)
    du = sqrt(_add(_mul(fs, fs), _mul(gs, gs)))
    rs, ru = torch.copysign(d, f), torch.copysign(du, f)
    c = torch.where(safe, _div(f1, d), _div(fs.abs(), du))
    s = torch.where(safe, _div(g, rs), _div(gs, ru))
    r = torch.where(safe, rs, _mul(ru, u))
    gz, fz = g == 0, f == 0
    c = torch.where(gz, one, torch.where(fz, zero, c))
    s = torch.where(gz, zero, torch.where(fz, torch.copysign(one, g), s))
    r = torch.where(gz, f, torch.where(fz, g1, r))
    return c, s, r


def _scale_to(anorm):
    """``ssteqr``'s scaling of a block by its largest magnitude: (1 above
    ssfmax, 2 below ssfmin, else 0; ``slascl``'s factor to and from)."""
    code = torch.where(anorm > _LA_SSFMAX, 1, torch.where(
        anorm < _LA_SSFMIN, 2, 0))
    to = torch.where(code == 1, _LA_SSFMAX, _LA_SSFMIN)
    return code, _div(to, anorm), _div(anorm, to)


def _qr_block2(a, c, b):
    """The eigenvalues of the 2 x 2 block [[a, b], [b, c]] that ``ssteqr``
    splits off: scaled, a small b's deflation test, else ``slaev2``."""
    anorm = torch.maximum(torch.maximum(c.abs(), a.abs()), b.abs())
    code, down, up = _scale_to(anorm)
    sc = code != 0
    a, c, b = (torch.where(sc, _mul(x, down), x) for x in (a, c, b))
    flip = c.abs() < a.abs()  # QR: the block read backwards
    a, c = torch.where(flip, c, a), torch.where(flip, a, c)
    small = _mul(b.abs(), b.abs()) <= _add(_mul(_mul(_LA_EPS2, a.abs()),
                                                c.abs()), _LA_SAFMIN)
    rt1, rt2 = _slae2(a, b, c)
    x, y = torch.where(small, a, rt1), torch.where(small, c, rt2)
    x, y = (torch.where(sc, _mul(v, up), v) for v in (x, y))
    keep = anorm == 0
    return torch.where(keep, a, x), torch.where(keep, c, y)


def _qr_block3(d0, d1, d2, e0, e1):
    """The eigenvalues of the unreduced 3 x 3 tridiagonal block: ``ssteqr``
    scaled, its implicit QL (QR where |d2| < |d0|: the same steps on the
    block read backwards) sweeps until an off-diagonal deflates, then the
    last 2 x 2 by ``slaev2``; NaN where 90 sweeps do not converge."""
    anorm = torch.maximum(torch.maximum(torch.maximum(torch.maximum(
        d2.abs(), d0.abs()), e0.abs()), d1.abs()), e1.abs())
    code, down, up = _scale_to(anorm)
    sc = code != 0
    d0, d1, d2, e0, e1 = (torch.where(sc, _mul(x, down), x)
                          for x in (d0, d1, d2, e0, e1))
    flip = d2.abs() < d0.abs()
    d0, d2 = torch.where(flip, d2, d0), torch.where(flip, d0, d2)
    e0, e1 = torch.where(flip, e1, e0), torch.where(flip, e0, e1)
    active = anorm != 0
    failed = torch.zeros_like(active)
    two = torch.full_like(d0, 2.0)

    def small(e, a, b):
        return _mul(e.abs(), e.abs()) <= _add(_mul(_mul(_LA_EPS2, a.abs()),
                                                  b.abs()), _LA_SAFMIN)

    for sweep in range(91):
        if not bool(active.any()):
            break
        t0, t1 = small(e0, d0, d1), small(e1, d1, d2)
        top = active & t0             # d0 found, then the (d1, d2) block
        mid = active & ~t0 & t1       # the (d0, d1) block, d2 found
        go = active & ~t0 & ~t1
        r1, r2 = _slae2(d1, e1, d2)
        last = top & ~t1
        d1, d2 = torch.where(last, r1, d1), torch.where(last, r2, d2)
        r1, r2 = _slae2(d0, e0, d1)
        d0, d1 = torch.where(mid, r1, d0), torch.where(mid, r2, d1)
        failed = failed | (go & (sweep == 90))
        go = go & (sweep < 90)
        active = go
        # one implicit QL sweep with the Wilkinson-like shift (M = 2, L = 0)
        p = d0
        g = _div(_sub(d1, p), _mul(two, e0))
        r = _slapy2(g, torch.ones_like(g))
        g = _add(_sub(d2, p), _div(e0, _add(g, torch.copysign(r, g))))
        s, c = torch.ones_like(g), torch.ones_like(g)
        p = torch.zeros_like(g)
        f, b = _mul(s, e1), _mul(c, e1)
        c, s, r = _slartg(g, f)
        g = _sub(d2, p)
        r = _add(_mul(_sub(d1, g), s), _mul(_mul(two, c), b))
        p = _mul(s, r)
        n2 = _add(g, p)
        g = _sub(_mul(c, r), b)
        f, b = _mul(s, e0), _mul(c, e0)
        c, s, r = _slartg(g, f)
        n_e1 = r
        g = _sub(d1, p)
        r = _add(_mul(_sub(d0, g), s), _mul(_mul(two, c), b))
        p = _mul(s, r)
        n1 = _add(g, p)
        g = _sub(_mul(c, r), b)
        n0, n_e0 = _sub(d0, p), g
        d0, d1, d2 = (torch.where(go, n, o) for n, o in
                      ((n0, d0), (n1, d1), (n2, d2)))
        e0, e1 = torch.where(go, n_e0, e0), torch.where(go, n_e1, e1)
    d0, d1, d2 = (torch.where(sc, _mul(x, up), x) for x in (d0, d1, d2))
    nan = torch.full_like(d0, math.nan)
    return tuple(torch.where(failed, nan, x) for x in (d0, d1, d2))


def eigvalsh3(h: torch.Tensor) -> torch.Tensor:
    """The ascending eigenvalues [..., 3] of symmetric float32 h
    [..., 3, 3] as the reference's ``jnp.linalg.eigvalsh`` computes them on
    the CPU (the table above this function): (h + h^T) / 2, ``ssyevd``'s
    scaling into [sqrt(smlnum), sqrt(bignum)], ``ssytd2``'s reflector,
    ``ssteqr``; NaN rows where the library reports no convergence (or h is
    not finite)."""
    lead = h.shape[:-2]
    h = ftz(h.reshape(-1, 3, 3).to(_F32))
    h = _mul(_add(h, h.transpose(1, 2)), 0.5)
    low = [h[:, i, j] for i in range(3) for j in range(i + 1)]
    anrm = low[0].abs()
    for v in low[1:]:
        anrm = torch.maximum(anrm, v.abs())
    up = anrm > _LA_RMAX
    scale = ((anrm > 0) & (anrm < _LA_RMIN)) | up
    sigma = _div(torch.where(up, _LA_RMAX, _LA_RMIN), anrm)
    h = torch.where(scale[:, None, None], _mul(h, sigma[:, None, None]), h)
    a11, a21, a31 = h[:, 0, 0], h[:, 1, 0], h[:, 2, 0]
    a22, a32, a33 = h[:, 1, 1], h[:, 2, 1], h[:, 2, 2]
    # ssytd2, i = 1: slarfg(2, a21, a31), its rescaling of a tiny beta
    one = torch.ones_like(a11)
    alpha, x = a21, a31
    reflect = x.abs() != 0
    beta = -torch.copysign(_slapy2(alpha, x.abs()), alpha)
    knt = torch.zeros_like(a11)
    safmin, rsafmn = 2.0 ** -102, 2.0 ** 102
    tiny = reflect & (beta.abs() < safmin)
    again = tiny.clone()
    for _ in range(20):
        if not bool(again.any()):
            break
        x = torch.where(again, _mul(x, rsafmn), x)
        beta = torch.where(again, _mul(beta, rsafmn), beta)
        alpha = torch.where(again, _mul(alpha, rsafmn), alpha)
        knt = knt + again.to(_F32)
        again = again & (beta.abs() < safmin) & (knt < 20)
    beta = torch.where(tiny, -torch.copysign(_slapy2(alpha, x.abs()), alpha),
                       beta)
    tau = _div(_sub(beta, alpha), beta)
    v2 = _mul(x, _div(one, _sub(alpha, beta)))
    for k in range(20):
        beta = torch.where(knt > k, _mul(beta, safmin), beta)
    # ssymv(L, 2, tau, A22, v = (1, v2)) into y = 0
    y0 = fma(tau, a22, torch.zeros_like(tau))
    y1 = fma(tau, a32, torch.zeros_like(tau))
    y0 = fma(tau, fma(a32, v2, torch.zeros_like(tau)), y0)
    y1 = fma(_mul(tau, v2), a33, y1)
    # alpha = -tau / 2 sdot(y, v), w = y + alpha v
    dt = fma(y0, one, _mul(y1, v2))
    al = _mul(_mul(-0.5, tau), dt)
    w0, w1 = fma(al, one, y0), fma(al, v2, y1)
    # ssyr2(L, 2, -1, v, w, A22): a column at a time, two saxpy each
    b22 = fma(-one, w0, a22)
    b32 = fma(-one, w1, a32)
    b22 = fma(-w0, one, b22)
    b32 = fma(-w0, v2, b32)
    b33 = fma(-v2, w1, a33)
    b33 = fma(-w1, v2, b33)
    d = (a11, torch.where(reflect, b22, a22), torch.where(reflect, b33, a33))
    e = (torch.where(reflect, beta, a21), torch.where(reflect, b32, a32))

    def split(ek, da, db):
        t = ek.abs()
        return (t == 0) | (t <= _mul(_mul(sqrt(da.abs()), sqrt(db.abs())),
                                     _LA_EPS))

    s0, s1 = split(e[0], d[0], d[1]), split(e[1], d[1], d[2])
    lo0, lo1 = _qr_block2(d[0], d[1], e[0])
    hi1, hi2 = _qr_block2(d[1], d[2], e[1])
    w3 = _qr_block3(*d, *e)
    w = torch.stack([
        torch.where(s0, d[0], torch.where(s1, lo0, w3[0])),
        torch.where(s0, torch.where(s1, d[1], hi1), torch.where(s1, lo1,
                                                                 w3[1])),
        torch.where(s0, torch.where(s1, d[2], hi2), torch.where(s1, d[2],
                                                                 w3[2]))],
        -1)
    w = torch.where(scale[:, None], _mul(w, _div(one, sigma)[:, None]), w)
    bad = torch.isnan(w).any(-1) | ~torch.isfinite(h).all(-1).all(-1)
    w = torch.where(bad[:, None], torch.full_like(w, math.nan), w)
    return torch.sort(w, -1)[0].reshape(lead + (3,))


def inv3(h: torch.Tensor) -> torch.Tensor:
    """h^{-1} of float32 h [B, 3, 3] as the reference's ``jnp.linalg.inv``
    on the CPU: ``sgetrf`` and ``strsm`` against each column of the
    identity (:func:`lu_solve`, a column a right-hand side)."""
    n = h.shape[0]
    eye = torch.eye(3, dtype=_F32, device=h.device)
    cols = lu_solve(h.repeat_interleave(3, 0), eye.repeat(n, 1))
    return cols.reshape(n, 3, 3).transpose(1, 2)


def ceres_covariance(h: torch.Tensor, final_score: torch.Tensor,
                     n_res: torch.Tensor, p2l: bool = True,
                     fallback=(0.1 ** 2, 0.1 ** 2, 0.01 ** 2)):
    """(cov [B, 3, 3], ok [B]) of ``ops/registration.py::ceres_covariance``
    from its Hessian h [B, 3, 3], final_score [B] and the residual counts
    n_res [B] (integers; residual dimension 1 a residual with ``p2l``, else
    2), rounded as the reference's program on the CPU: its
    ``lapack_ssyevd_ffi``, ``lapack_sgetrf_ffi`` and two
    ``lapack_strsm_ffi`` calls (:func:`eigvalsh3`, :func:`inv3`), ok where
    the smallest eigenvalue is above 1e-9 and the residual dimension less 3
    is positive, the scale (30 final_score) / max(denominator, 1), every
    subnormal operand and result flushed; the diagonal ``fallback`` where
    not ok.  ``csrc/refmath.cu``'s ``refmath_ceres_covariance_kernel``
    runs the same steps, a thread a row."""
    dt, dev = h.dtype, h.device
    h = ftz(h)
    ok = eigvalsh3(h)[:, 0] > f32_ftz(1e-9)
    denom = ((1 if p2l else 2) * n_res.long() - 3).to(dt)
    ok = ok & (denom > 0)
    scale = ftz(ftz(30.0 * final_score) / torch.clamp(denom, min=1.0))
    eye = torch.eye(3, dtype=dt, device=dev)
    hinv = inv3(ftz(h + (~ok).to(dt)[:, None, None] * eye))
    cov = ftz(scale[:, None, None] * hinv)
    diag = torch.diag(torch.tensor(fallback, dtype=dt, device=dev))
    return torch.where(ok[:, None, None], cov, diag), ok


# ---- ScanContext's keys and distance ---------------------------------------
#
# Read from the reference's compiled CPU program (jax 0.9.0, optimized HLO
# and object code of ``context_descriptors``, ``detect`` and its vmapped
# form; the Gram matrix held bit for bit against the same dot compiled
# alone): every mean, norm and sum over the descriptor is XLA's tree
# reduction (:func:`tree_sum`: reduce-windows of 32, the ring axis of 40
# padded 12 / 12, the sector axis of 120 padded 4 / 4), its squares and
# differences rounded and stored before the sum; a mean is the sum times
# the float32 reciprocal of the count; the Gram matrix is the runtime's
# matrix product, one fused multiply-add a ring in order from zero; the
# sector keys' difference fuses the query's product, fma(vq_sum, 1 / R,
# -vc); the ring-key distance fuses the odometry term, fma(m, m, sum) with
# m = 10 sim; the similarity a true division by max(|q| |c|, 1e-20), its
# sum divided by the effective count as a float.  The reference's threads
# flush subnormal operands and results (DAZ / FTZ): every step here does.


def _tree_sum_ftz(x: torch.Tensor) -> torch.Tensor:
    """:func:`tree_sum` of x (flushed) over the last axis, each sum
    flushed (add.rn.ftz on the card).  Sums of flushed values of one sign
    are zero or normal, so there the flushes change nothing and are
    skipped; only mixed signs can cancel to a subnormal sum."""
    if bool((x >= 0).all()) or bool((x <= 0).all()):
        return tree_sum(x)
    n = x.shape[-1]
    if n <= TREE_WINDOW:
        acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for k in range(n):
            acc = ftz(acc + x[..., k])
        return acc
    m = -(-n // TREE_WINDOW)
    pad = m * TREE_WINDOW - n
    xp = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2)).reshape(
        x.shape[:-1] + (m, TREE_WINDOW))
    acc = torch.zeros(xp.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(TREE_WINDOW):
        acc = ftz(acc + xp[..., k])
    return _tree_sum_ftz(acc)


#: the longest axis a ScanContext sum reduces in two levels of windows
SC_AXIS_MAX = TREE_WINDOW * TREE_WINDOW


def sc_key(desc: torch.Tensor, ring: bool = True) -> torch.Tensor:
    """ScanContext's ring key (``ring``: the mean of each ring over its
    sectors, [..., R]) or sector key (the mean of each sector over the
    rings, [..., S]) of descriptors [..., R, S]: the tree sum times the
    float32 reciprocal of the count, as ``jnp.mean`` is compiled."""
    x = ftz(desc) if ring else ftz(desc).transpose(-1, -2)
    return mul_ftz(_tree_sum_ftz(x), recip(x.shape[-1]))


def sc_ring_distance(query_key: torch.Tensor, db_key: torch.Tensor,
                     db_mask: torch.Tensor,
                     odom: "torch.Tensor | None") -> torch.Tensor:
    """``retrieve``'s squared ring-key distance [..., N] of query keys
    [..., R] to the database's keys [N, R]: sum_r (db - q)^2 (each
    difference and square rounded, the tree sum), plus (10 odom)^2 fused
    into it where ``odom`` [..., N] is given (the odometry-coupled search
    key), +inf where ``db_mask`` [..., N] is false."""
    d = ftz(ftz(db_key) - ftz(query_key)[..., None, :])
    s = _tree_sum_ftz(mul_ftz(d, d))
    if odom is not None:
        m = mul_ftz(ftz(odom), 10.0)
        s = fma(m, m, s)
    return torch.where(db_mask, s, torch.full_like(s, math.inf))


def _fused_ftz(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 of p + c, rounded once and flushed, for float64 p (an exact
    product of flushed float32 values) and c (a flushed float32 value):
    :func:`fma` without its operands' flushes.  Where the float64 sum lies
    on no float32 tie and its rounding is not at or below 2^-126 (nearly
    everywhere), its float32 rounding is the result; the few others take
    :func:`_fused` and :func:`_flush`."""
    s = p + c
    r = s.to(_F32)
    a = torch.abs(r)
    bad = ((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000) | \
        ((a <= _MIN_NORM) & (a != 0))
    if bool(bad.any()):
        idx = bad.nonzero(as_tuple=True)
        ps, cs = p.expand_as(s)[idx], c.expand_as(s)[idx]
        r[idx] = _flush(_fused(ps, cs), lambda: _two_sum(ps, cs))
    return r


#: (query, candidate) pairs the plain ``sc_distance`` takes at a time (its
#: [pairs, S, S] alignment terms in a few MB)
SC_PAIRS_CHUNK = 64


def sc_distance(query: torch.Tensor, candidate: torch.Tensor,
                search_ratio: float = 0.1):
    """(min distance, argmin shift) between ScanContext descriptors [..., R,
    S] (broadcast together) as the reference's program computes
    ``sc_distance``: the sector keys' aligning shift (the first least
    sum of squared differences), then the column-wise cosine distance at
    the shifts within round(0.5 ratio S) of it (the others are +inf and
    never win, so only those are computed), the first least of them.  A
    Gram entry is sum_r q[r, col] c[r, col - shift], one fused
    multiply-add a ring from zero; a norm the IEEE root of the tree sum of
    rounded squares.  The pairs are independent: taken
    :data:`SC_PAIRS_CHUNK` at a time."""
    r_, s_ = query.shape[-2:]
    if max(r_, s_) > SC_AXIS_MAX:
        raise ValueError(f"sc_distance: descriptors of {r_} x {s_} (each "
                         f"axis at most {SC_AXIS_MAX})")
    lead = torch.broadcast_shapes(query.shape[:-2], candidate.shape[:-2])
    q = ftz(query.expand(lead + (r_, s_)).reshape(-1, r_, s_))
    c = ftz(candidate.expand(lead + (r_, s_)).reshape(-1, r_, s_))
    radius = int(round(0.5 * search_ratio * s_))
    parts = [_sc_distance_pairs(q[i:i + SC_PAIRS_CHUNK],
                                c[i:i + SC_PAIRS_CHUNK], radius)
             for i in range(0, q.shape[0], SC_PAIRS_CHUNK)]
    if not parts:
        return (torch.zeros(lead, dtype=_F32, device=q.device),
                torch.zeros(lead, dtype=torch.int64, device=q.device))
    return (torch.cat([d for d, _ in parts]).reshape(lead),
            torch.cat([b for _, b in parts]).reshape(lead))


def _sc_distance_pairs(q: torch.Tensor, c: torch.Tensor, radius: int):
    """:func:`sc_distance` of flushed pairs q, c [P, R, S]."""
    p_, r_, s_ = q.shape
    dev = q.device
    inv_r = recip(r_)
    cols = torch.arange(s_, device=dev)
    src = torch.remainder(cols[None, :] - cols[:, None], s_)  # [shift, col]
    # the sector keys' alignment: fma(vq_sum, 1 / R, -vc[col - shift])
    vq_sum = _tree_sum_ftz(q.transpose(-1, -2))  # [P, S]
    vc = mul_ftz(_tree_sum_ftz(c.transpose(-1, -2)), inv_r)
    diff = _fused_ftz(vq_sum[:, None, :].to(_F64) * inv_r,
                      -vc[:, src].to(_F64))  # [P, shift, col]
    center = torch.argmin(_tree_sum_ftz(mul_ftz(diff, diff)), -1)
    # the shifts the search reaches
    if 2 * radius + 1 >= s_:
        shifts = cols.expand(p_, s_)
    else:
        shifts = torch.remainder(
            center[:, None] + torch.arange(-radius, radius + 1, device=dev),
            s_)
    w = shifts.shape[-1]
    csrc = torch.remainder(cols - shifts[..., None], s_)  # [P, W, S]
    # the Gram entries at (shift, col), a ring at a time from zero
    q64 = q.to(_F64)
    dot = torch.zeros((p_, w, s_), dtype=_F32, device=dev)
    for r in range(r_):
        cr = torch.gather(c[:, r, None, :].expand(p_, w, s_), -1, csrc)
        dot = _fused_ftz(q64[:, r, None, :] * cr.to(_F64), dot.to(_F64))
    qn = sqrt(_tree_sum_ftz(mul_ftz(q, q).transpose(-1, -2)))  # [P, S]
    cn = sqrt(_tree_sum_ftz(mul_ftz(c, c).transpose(-1, -2)))
    cn = torch.gather(cn[:, None, :].expand(p_, w, s_), -1, csrc)
    eff = (qn[:, None, :] > 0) & (cn > 0)
    den = torch.clamp(mul_ftz(qn[:, None, :], cn), min=1e-20)
    sim = torch.where(eff, ftz(dot / den), torch.zeros_like(dot))
    count = torch.clamp(eff.sum(-1), min=1).to(_F32)
    dists = ftz(1.0 - ftz(_tree_sum_ftz(sim) / count))  # [P, W]
    masked = torch.full((p_, s_), math.inf, dtype=_F32, device=dev)
    masked = masked.scatter(-1, shifts, dists)
    best = torch.argmin(masked, -1)
    return torch.gather(masked, -1, best[:, None])[:, 0], best


# ---- the measured covariances' whitening -----------------------------------


def chol3(a: torch.Tensor):
    """(L, ok) of the lower Cholesky factor of symmetric a [B, 3, 3] as the
    reference's ``jnp.linalg.cholesky`` computes it on the CPU: jaxlib's
    ``lapack_spotrf_ffi``, SciPy's OpenBLAS ``spotf2_L`` at this size: for
    column j, a_jj - sdot(row j) (:func:`_strided_dot`) and its IEEE root,
    the entries below it a_ij - sgemv (:func:`_chain`) times the float32
    1 / l_jj; a pivot that is not above zero stops it (ok false, and
    jax fills the factor with NaN), every subnormal flushed."""
    a = ftz(a)
    n = a.shape[0]
    lo = torch.zeros_like(a)
    ok = torch.ones(n, dtype=torch.bool, device=a.device)
    one = torch.ones((), dtype=_F32, device=a.device)
    for j in range(3):
        ajj = a[:, j, j]
        if j:
            ajj = ftz(ajj - _strided_dot(lo[:, j, :j], lo[:, j, :j]))
        ok = ok & ~(ajj <= 0)
        ljj = sqrt(torch.where(ajj > 0, ajj, torch.ones_like(ajj)))
        lo[:, j, j] = torch.where(ajj > 0, ljj, ajj)
        if j < 2:
            below = a[:, j + 1:, j]
            if j:
                below = ftz(below - _chain(lo[:, j + 1:, :j], lo[:, j, :j]))
            lo[:, j + 1:, j] = ftz(below * ftz(one / ljj)[:, None])
    return lo, ok


def measured_sqrt_info(cov: torch.Tensor, scale: torch.Tensor,
                       fallback: torch.Tensor) -> torch.Tensor:
    """``ops/posegraph.py::measured_sqrt_info`` written out as the
    reference's eager calls round it on the CPU: 0.5 (cov + cov^T) +
    1e-9 I, its inverse (:func:`inv3`), the product by the edge's scale
    [E], the Cholesky input symmetrised, (a + a^T) / 2, and its factor
    (:func:`chol3`); where the factor failed or is not finite the
    ``fallback`` [E, 3, 3]."""
    c = ftz(cov.to(_F32))
    eye = torch.eye(3, dtype=_F32, device=c.device)
    covs = ftz(ftz(0.5 * ftz(c + c.transpose(-1, -2))) + f32_ftz(1e-9) * eye)
    info = mul_ftz(inv3(covs), scale[:, None, None])
    sym = ftz(ftz(info + info.transpose(-1, -2)) * 0.5)
    lo, ok = chol3(sym)
    ok = ok & torch.isfinite(lo.reshape(lo.shape[0], -1)).all(-1)
    return torch.where(ok[:, None, None], lo, fallback)
