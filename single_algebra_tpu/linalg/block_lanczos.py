"""Block Golub-Kahan-Lanczos bidiagonalization — the matmul-shaped Lanczos.

The scalar GKL in :mod:`.lanczos` advances the Krylov space one vector at a
time: every step is two rank-1 matvecs (``[n,1]`` products — the worst
possible matmul shape) plus reorthogonalization, and the steps are strictly
sequential. The block variant advances ``b`` vectors per step:

* each step's products are ``A @ [p, b]`` / ``A^T @ [n, b]`` — real matmul
  tiles that amortize one pass over the matrix across b Krylov directions;
* the sequential depth for the same Krylov dimension drops b-fold;
* clustered singular values (common in scRNA spectra) are resolved
  together instead of one per step.

Recurrence (block GKL with full reorthogonalization):

    U_j R_j = A V_j - U_{j-1} L_{j-1}^T     (QR, [n, b])
    V_{j+1} L_j = A^T U_j - V_j R_j^T       (QR, [p, b])

giving ``A [V_1..V_m] = [U_1..U_m] B`` with upper block-bidiagonal ``B``
(``B[j,j] = R_j``, ``B[j,j+1] = L_j^T``); the small ``[mb, mb]`` SVD of B
yields the Ritz triplets exactly as in the scalar case.

Same semantics as :func:`lanczos_svd` (raw operator, no centering — the
reference's Lanczos path, SURVEY.md §3.2) and the same two execution modes
(fixed depth / convergence-adaptive while_loop on Ritz movement).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..types import MATMUL_PRECISION
from .svd import SvdResult, _cholesky_qr2_with_r

__all__ = ["block_lanczos_svd"]


def _qr_tall(X: jnp.ndarray):
    """(Q, R) for a tall-skinny block; CholeskyQR2 on big f32 blocks (matmuls),
    Householder otherwise."""

    if X.shape[0] >= 16384 and X.dtype == jnp.float32:
        return _cholesky_qr2_with_r(X)
    q, r = jnp.linalg.qr(X)
    return q, r


@partial(
    jax.jit,
    static_argnames=("n_components", "block_size", "steps", "tol"),
)
def block_lanczos_svd(
    op,
    n_components: int,
    block_size: int = 8,
    steps: int | None = None,
    seed: int | jnp.ndarray = 42,
    tol: float | None = None,
) -> SvdResult:
    """Truncated SVD of ``op`` via block Golub-Kahan bidiagonalization.

    ``steps`` counts BLOCK steps; the Krylov dimension is
    ``steps * block_size``. Default budget matches the scalar path's
    Krylov dimension (``max(8k, 128)``, adaptive: ``max(16k, 384)``).
    """

    n, p = op.shape
    k = n_components
    # a block wider than the operator would make the panel QRs rank-
    # deficient with mismatched [b, b] factor slots
    b = max(min(block_size, min(n, p)), 1)
    if steps is None:
        kdim = max(16 * k, 384) if tol is not None else max(8 * k, 128)
        steps = max(-(-min(kdim, min(n, p)) // b), 2)
    m = steps
    mb = m * b

    dtype = op.mv(jnp.zeros((p, 1), jnp.float32)).dtype
    eps = jnp.asarray(jnp.finfo(dtype).tiny * 1e8, dtype)
    op_mv = getattr(op, "mv_precise", op.mv)
    op_rmv = getattr(op, "rmv_precise", op.rmv)

    key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    V1, _ = jnp.linalg.qr(jax.random.normal(key, (p, b), dtype=dtype))

    # stacked Krylov bases [mb, n] / [mb, p]; unfilled rows zero
    U = jnp.zeros((mb, n), dtype)
    V = jnp.zeros((mb, p), dtype)
    # B assembled from per-step diagonal (R_j) and coupling (L_j) blocks
    Rs = jnp.zeros((m, b, b), dtype)
    Ls = jnp.zeros((m, b, b), dtype)

    def reorth(basis, X):
        # two passes of block classical Gram-Schmidt against filled rows
        for _ in range(2):
            coeff = jnp.dot(basis, X, precision=MATMUL_PRECISION)
            X = X - jnp.dot(basis.T, coeff, precision=MATMUL_PRECISION)
        return X

    def body(j, carry):
        U, V, Rs, Ls, u_prev, v_cur, L_prev = carry
        z = jnp.asarray(0, jnp.asarray(j).dtype)
        V = jax.lax.dynamic_update_slice(V, v_cur.T, (j * b, z))

        Au = op_mv(v_cur) - jnp.dot(
            u_prev, L_prev.T, precision=MATMUL_PRECISION
        )
        Au = reorth(U, Au)
        u, R = _qr_tall(Au)
        U = jax.lax.dynamic_update_slice(U, u.T, (j * b, z))
        Rs = Rs.at[j].set(R)

        W = op_rmv(u) - jnp.dot(v_cur, R.T, precision=MATMUL_PRECISION)
        W = reorth(V, W)
        v_next, L = _qr_tall(W)
        Ls = Ls.at[j].set(L)

        return (U, V, Rs, Ls, u, v_next, L)

    init = (
        U, V, Rs, Ls,
        jnp.zeros((n, b), dtype),
        V1,
        jnp.zeros((b, b), dtype),
    )

    def assemble_B(Rs, Ls):
        B = jnp.zeros((mb, mb), dtype)

        def put(j, B):
            B = jax.lax.dynamic_update_slice(B, Rs[j], (j * b, j * b))
            # superdiagonal block L_j^T goes at (j, j+1); clamp the last
            # one onto the diagonal block column and mask it off instead
            # of branching (it is written then overwritten harmlessly
            # only when j+1 < m)
            col = jnp.minimum((j + 1) * b, mb - b)
            blk = jnp.where(j + 1 < m, Ls[j].T, jnp.zeros((b, b), dtype))
            return jax.lax.dynamic_update_slice(B, blk + jax.lax.dynamic_slice(B, (j * b, col), (b, b)), (j * b, col))

        return jax.lax.fori_loop(0, m, put, B)

    def ritz(Rs, Ls):
        Bm = assemble_B(Rs, Ls)
        return jnp.linalg.svd(Bm, compute_uv=False)[:k]

    if tol is None:
        carry = jax.lax.fori_loop(0, m, body, init)
    else:
        tol_arr = jnp.asarray(tol, dtype)

        def w_cond(state):
            j, done, _, _ = state
            return jnp.logical_and(j < m, jnp.logical_not(done))

        def w_body(state):
            j, _, s_prev, carry = state
            carry = body(j, carry)
            s_now = ritz(carry[2], carry[3])
            scale = jnp.maximum(s_now[0], eps)
            moved = jnp.max(jnp.abs(s_now - s_prev)) / scale
            # Krylov exhaustion: coupling block underflow
            exhausted = jnp.linalg.norm(carry[6]) <= eps
            return (
                j + 1,
                jnp.logical_or(moved < tol_arr, exhausted),
                s_now,
                carry,
            )

        state = (
            jnp.asarray(0, jnp.int32),
            jnp.asarray(False),
            jnp.full((k,), jnp.inf, dtype),
            init,
        )
        _, _, _, carry = jax.lax.while_loop(w_cond, w_body, state)

    U, V, Rs, Ls, _, _, _ = carry
    Bm = assemble_B(Rs, Ls)
    pb, s, qtb = jnp.linalg.svd(Bm)
    u_full = jnp.dot(U.T, pb, precision=MATMUL_PRECISION)
    v_full = jnp.dot(V.T, qtb.T, precision=MATMUL_PRECISION)
    return SvdResult(u=u_full[:, :k], s=s[:k], vt=v_full[:, :k].T)
