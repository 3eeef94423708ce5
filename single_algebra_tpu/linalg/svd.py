"""Randomized truncated SVD and the deterministic sign convention.

JAX rebuild of ``single-svdlib::randomized`` as pinned by the
reference's call sites (``randomized_svd(matrix, n_components, n_oversamples,
n_power_iterations, normalizer, center, seed, verbose)`` at
``src/dimred/pca/sparse/mod.rs:170-179``; ``svd_flip(u, vt, u_based=false)``
at ``sparse/mod.rs:201-206``). Halko-Martinsson-Tropp randomized range
finding with oversampling and normalized power iterations, expressed as a
jitted XLA computation over the operator seam — the sketch SpMM ``A @ Omega``
and power passes run on the SpMM kernel; QR/LU/small-SVD run as matmuls via
``jnp.linalg``.

Seeding uses ``jax.random`` — reproducible per seed, but not bitwise equal
to the Rust rand stream; parity with the reference is statistical (explained
variance / subspace angles), per SURVEY.md §7.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..types import MATMUL_PRECISION, PowerIterationNormalizer

__all__ = ["SvdResult", "randomized_svd", "svd_flip", "cholesky_qr2"]


class SvdResult(NamedTuple):
    """Mirror of single-svdlib's result struct fields ``.u/.s/.vt``
    (reference usage src/dimred/pca/sparse/mod.rs:201-214)."""

    u: jnp.ndarray  # [n, k]
    s: jnp.ndarray  # [k]
    vt: jnp.ndarray  # [k, p]


def cholesky_qr2(Y: jnp.ndarray) -> jnp.ndarray:
    """Orthonormal basis of range(Y) via two shifted-CholeskyQR rounds.

    Tall-skinny QR built from Gram matrices (matmuls) + tiny Cholesky
    factors — far fewer sequential steps than Householder QR for
    [n >> l] sketches. The first round's diagonal shift keeps the
    Cholesky factorization positive-definite even when Y is very
    ill-conditioned; the second (unshifted) round restores orthogonality
    to ~sqrt(eps).

    **Column-norm rescue.** A self-Gram ``Y^T Y`` computed through a
    multi-pass bf16 decomposition of f32 can under-measure the DIAGONAL
    by a systematic ~2^-16 (the dropped lo*lo terms of squares are
    always positive), leaving Q's column norms ~1e-5 long. Since
    ``B = A_c^T Q`` inherits those norms, every A-space randomized
    engine's explained variance would carry a UNIFORM relative bias of
    that size, immune to solver budget. The cure is one elementwise
    pass: re-measure the column norms (plain f32 reduce, no matmul) and
    rescale.
    """

    def round_(Yc, shift):
        g = jax.lax.dot_general(
            Yc, Yc,
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=MATMUL_PRECISION,
        )
        if shift:
            l = g.shape[0]
            s = (
                jnp.finfo(jnp.float32).eps
                * jnp.trace(g)
                * jnp.asarray(11 * (Yc.shape[0] + l + 1), jnp.float32)
            )
            g = g + s * jnp.eye(l, dtype=g.dtype)
        r = jnp.linalg.cholesky(g.astype(Yc.dtype), upper=True)
        return jax.lax.linalg.triangular_solve(
            r, Yc, left_side=False, lower=False
        )

    return _colnorm_rescale(round_(round_(Y, True), False))[0]


def _colnorm_rescale(Q: jnp.ndarray):
    """(Q with exactly-unit f32 column norms, the norms it had).

    Elementwise square + reduce — immune to a decomposed self-Gram's
    systematic ~2^-16 diagonal bias (see :func:`cholesky_qr2`)."""

    nrm = jnp.sqrt(jnp.maximum(jnp.sum(Q * Q, axis=0), 1e-30))
    return Q * (1.0 / nrm)[None, :], nrm


# Householder QR beats CholeskyQR2's extra Gram passes below this many rows
_CHOLQR_MIN_ROWS = 16384


def _orthonormalize(Y: jnp.ndarray, normalizer: PowerIterationNormalizer):
    if normalizer == PowerIterationNormalizer.QR:
        if Y.shape[0] >= _CHOLQR_MIN_ROWS and Y.dtype == jnp.float32:
            return cholesky_qr2(Y)
        q, _ = jnp.linalg.qr(Y)
        return q
    if normalizer == PowerIterationNormalizer.LU:
        import jax.scipy.linalg as jsl

        pl_ = jsl.lu(Y, permute_l=True)[0]
        return pl_
    return Y


@partial(
    jax.jit,
    static_argnames=(
        "n_components",
        "n_oversamples",
        "n_power_iterations",
        "normalizer",
    ),
)
def randomized_svd(
    op,
    n_components: int,
    n_oversamples: int = 10,
    n_power_iterations: int = 7,
    normalizer: PowerIterationNormalizer = PowerIterationNormalizer.QR,
    seed: int | jnp.ndarray = 42,
) -> SvdResult:
    """Truncated SVD of ``op`` (any operator with ``mv``/``rmv``/``shape``).

    Centering is handled by wrapping ``op`` in a ``CenteredOperator`` —
    the equivalent of the reference's ``center: bool`` flag.
    """

    n, p = op.shape
    l = min(n_components + n_oversamples, min(n, p))
    # f32 probe infers the operator's native dtype (an f64 operator
    # promotes it; an f32 one must NOT be promoted by an x64-default probe)
    dtype = jnp.result_type(op.mv(jnp.zeros((p, 1), jnp.float32)).dtype)

    key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    omega = jax.random.normal(key, (p, l), dtype=dtype)

    # power iterations ride the operator's FAST products when it offers
    # them (hi-only bf16 on the densified/tiled engines) — subspace
    # perturbation enters the spectrum only at second order; the final
    # projection below uses the precise form
    mv_fast = getattr(op, "mv_fast", op.mv)
    rmv_fast = getattr(op, "rmv_fast", op.rmv)

    Y = mv_fast(omega)  # [n, l]

    # normalized power iterations (subspace iteration on A A^T), rolled into
    # a fori_loop so the body — two SpMM passes + two normalizations — is
    # compiled once regardless of q
    def power_body(_, Yc):
        Yc = _orthonormalize(Yc, normalizer)
        Z = rmv_fast(Yc)  # [p, l]
        Z = _orthonormalize(Z, normalizer)
        return mv_fast(Z)

    if n_power_iterations > 0:
        Y = jax.lax.fori_loop(0, n_power_iterations, power_body, Y)

    Q = _final_basis(Y)  # [n, l] orthonormal
    # final projection at full precision (hi+lo path on densified operators)
    rmv_final = getattr(op, "rmv_precise", op.rmv)
    Bt = rmv_final(Q)  # [p, l] == (Q^T A)^T

    if p >= _CHOLQR_MIN_ROWS and Bt.dtype == jnp.float32:
        # avoid factorizing an [l, p] matrix directly (Householder QR/SVD
        # at these shapes are compile-time hogs): Bt = Qb R with a
        # Gram-based QR, then SVD the tiny [l, l] factor.
        # B = Bt.T = R^T Qb^T;  svd(R^T) = (ub, s, vr^T)  =>
        # svd(B) = (ub, s, vr^T Qb^T)
        Qb, R = _cholesky_qr2_with_r(Bt)
        ub, s, vtr = jnp.linalg.svd(R.T, full_matrices=False)
        vt = jnp.dot(vtr, Qb.T, precision=MATMUL_PRECISION)
    else:
        ub, s, vt = jnp.linalg.svd(Bt.T, full_matrices=False)
    U = jnp.dot(Q, ub, precision=MATMUL_PRECISION)
    return SvdResult(
        u=U[:, :n_components], s=s[:n_components], vt=vt[:n_components]
    )


def _final_basis(Y: jnp.ndarray) -> jnp.ndarray:
    if Y.shape[0] >= _CHOLQR_MIN_ROWS and Y.dtype == jnp.float32:
        return cholesky_qr2(Y)
    return jnp.linalg.qr(Y)[0]


def _cholesky_qr2_with_r(Y: jnp.ndarray):
    """(Q, R) with Q orthonormal via two Gram rounds, R = R2 @ R1."""

    def round_(Yc, shift):
        g = jax.lax.dot_general(
            Yc,
            Yc,
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=MATMUL_PRECISION,
        )
        if shift:
            l = g.shape[0]
            s = (
                jnp.finfo(jnp.float32).eps
                * jnp.trace(g)
                * jnp.asarray(11 * (Yc.shape[0] + l + 1), jnp.float32)
            )
            g = g + s * jnp.eye(l, dtype=g.dtype)
        r = jnp.linalg.cholesky(g.astype(Yc.dtype), upper=True)
        q = jax.lax.linalg.triangular_solve(
            r, Yc, left_side=False, lower=False
        )
        return q, r

    q1, r1 = round_(Y, True)
    q2, r2 = round_(q1, False)
    # fold the elementwise-measured column norms into R so Q R == Y still holds
    # and the sigma path downstream sees unbiased norms (see
    # cholesky_qr2's column-norm-rescue note)
    qs, nrm = _colnorm_rescale(q2)
    return qs, nrm[:, None] * jnp.dot(r2, r1, precision=MATMUL_PRECISION)


@partial(jax.jit, static_argnames=("u_based_decision",))
def svd_flip(
    u: jnp.ndarray, vt: jnp.ndarray, u_based_decision: bool = False
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Deterministic sign convention for (U, Vt).

    sklearn ``svd_flip`` semantics; the reference calls the V-based variant
    after both SVD methods (``svd_flip(u, vt, false)``,
    src/dimred/pca/sparse/mod.rs:203). Signs are chosen from the
    largest-|.|-entry of each right singular vector (row of Vt) so that
    entry is positive.
    """

    if u_based_decision:
        idx = jnp.argmax(jnp.abs(u), axis=0)
        signs = jnp.sign(u[idx, jnp.arange(u.shape[1])])
    else:
        idx = jnp.argmax(jnp.abs(vt), axis=1)
        signs = jnp.sign(vt[jnp.arange(vt.shape[0]), idx])
    signs = jnp.where(signs == 0, 1.0, signs).astype(u.dtype)
    return u * signs[None, :], vt * signs[:, None]
