"""Cost assembly and small numeric utilities.

JAX equivalents of the reference's `isls/utils.py` helpers:
via-point quadratic cost encoding (`find_precs` `utils.py:101-115`,
`find_mus` `utils.py:95-99`), the n-th order integrator builder
(`get_double_integrator_AB` `utils.py:266-276`), lifted-matrix helpers
(`selection_matrix` `utils.py:79-87`, `construct_Z` `utils.py:89-93`),
nullspace helpers (`utils.py:67-77`), augmented-state cost helpers
(`utils.py:118-143`), and `run_once` (`utils.py:278-284`).

These are problem-construction utilities: they run once on the host, so
they return device arrays but are not themselves jit hot paths. The key
difference from the reference is that per-timestep costs stay stacked
`(N, d, d)` (scan/vmap friendly) instead of scipy sparse block-diagonals.
"""

from __future__ import annotations

import math
import jax.numpy as jnp
import numpy as np

from ilqr_admm_tpu.problem import QuadCost


def find_mus(zs, seq):
    """Stack via-point targets along the horizon: xd = zs[seq] flattened.

    zs: (n_via, d), seq: (N,) int. Returns (N*d,) like `utils.py:95-99`.
    """
    zs = jnp.asarray(zs)
    seq = jnp.asarray(seq)
    return zs[seq].reshape(-1)


def find_precs(Qs, seq, sqrt: bool = False):
    """Per-timestep precision matrices Q_t = Qs[seq[t]], stacked (N, d, d).

    The reference returns a sparse block-diagonal (`utils.py:101-115`);
    here the stacked form is canonical (use `QuadCost.lifted_Q()` for the
    dense lifted matrix). With sqrt=True also returns symmetric PSD
    matrix square roots S with S @ S = Q_t (the reference's entry-wise
    ** 0.5 is only a square root for diagonal blocks and silently drops
    off-diagonal coupling — NaNs on negative entries in the reference;
    built to intent per SURVEY §2 defect policy).
    """
    Qs = jnp.asarray(Qs)
    seq = jnp.asarray(seq)
    precs = Qs[seq]
    if sqrt:
        w, V = jnp.linalg.eigh(precs)
        w = jnp.sqrt(jnp.maximum(w, 0.0))
        return precs, jnp.einsum("tij,tj,tkj->tik", V, w, V)
    return precs


def viapoint_cost(zs, Qs, seq, u_std, u_dim: int) -> QuadCost:
    """Build a QuadCost from via-point specs (reference `base.py:81-89`).

    R_t = u_std * I_{u_dim} for every t (reference `base.py:86,89`).
    """
    Q = find_precs(Qs, seq)
    xd = jnp.asarray(zs)[jnp.asarray(seq)]
    N = xd.shape[0]
    R = jnp.broadcast_to(u_std * jnp.eye(u_dim, dtype=Q.dtype), (N, u_dim, u_dim))
    return QuadCost(Q=Q, xd=xd, R=R)


def get_double_integrator_AB(nb_dim: int, nb_deriv: int = 2, dt: float = 0.01):
    """Discrete n-th order integrator (exact ZOH): reference `utils.py:266-276`.

    Returns A (nb_dim*nb_deriv, nb_dim*nb_deriv), B (nb_dim*nb_deriv, nb_dim).
    """
    A1 = np.zeros((nb_deriv, nb_deriv))
    for i in range(nb_deriv):
        A1 += np.diag(np.ones(nb_deriv - i), i) * dt**i / math.factorial(i)
    B1 = np.zeros((nb_deriv, 1))
    for i in range(1, nb_deriv + 1):
        B1[nb_deriv - i, 0] = dt**i / math.factorial(i)
    return (
        jnp.asarray(np.kron(A1, np.eye(nb_dim))),
        jnp.asarray(np.kron(B1, np.eye(nb_dim))),
    )


def selection_matrix(m: int, n: int, horizon: int):
    """Block lower-triangular ones mask ((horizon+1)m, (horizon+1)n).

    Reference `utils.py:79-87`.
    """
    rows = np.arange(horizon + 1)
    mask = (rows[:, None] >= rows[None, :]).astype(float)
    return jnp.asarray(np.kron(mask, np.ones((m, n))))

def construct_Z(d: int, N: int):
    """Block down-shift operator Z: (d(N+1), d(N+1)), reference `utils.py:89-93`."""
    Z = np.zeros((d * (N + 1), d * (N + 1)))
    i, j = np.indices(Z.shape)
    Z[i == d + j] = 1.0
    return jnp.asarray(Z)


def nullspace_matrix(J):
    """I - pinv(J) J (reference `utils.py:67-71`)."""
    J = jnp.asarray(J)
    return jnp.eye(J.shape[-1], dtype=J.dtype) - jnp.linalg.pinv(J) @ J


def nullspace_matrix2(J):
    """N N^T with N an orthonormal nullspace basis (reference `utils.py:73-77`)."""
    J = np.asarray(J)
    import scipy.linalg

    Nmat = scipy.linalg.null_space(J)
    return jnp.asarray(Nmat @ Nmat.T)


# -- augmented-state cost helpers (reference `utils.py:118-143`) ------------


def augment_Qt(Q):
    Q = jnp.asarray(Q)
    n = Q.shape[0]
    out = jnp.eye(n + 1, dtype=Q.dtype)
    return out.at[:n, :n].set(Q)


def augment_mut(mu):
    mu = jnp.asarray(mu)
    n = mu.shape[0]
    M = jnp.eye(n + 1, dtype=mu.dtype)
    return M.at[n:, :-1].set(-mu)


def find_augmented_precs(zs, Qs, seq):
    """Stacked augmented precisions (N, d+1, d+1), reference `utils.py:130-137`."""
    zs = jnp.asarray(zs)
    Qs = jnp.asarray(Qs)
    seq = np.asarray(seq)
    blocks = []
    for t in range(seq.shape[0]):
        Qt = augment_Qt(Qs[seq[t]])
        M = augment_mut(zs[seq[t]])
        blocks.append(M @ Qt @ M.T)
    return jnp.stack(blocks)


def batch_cost_vars(zs, Qs, seq):
    """(mu, Q) pair for end-effector-space tasks (reference `utils.py:139-143`)."""
    return find_mus(zs, seq), find_precs(Qs, seq)


def run_once(f):
    """Memoizing run-once decorator (reference `utils.py:278-284`)."""

    def wrapper(*args, **kwargs):
        if not wrapper.has_run:
            # mark has_run only AFTER success: a first call that raises
            # must not poison every later call with a silent None
            wrapper.result = f(*args, **kwargs)
            wrapper.has_run = True
        return wrapper.result

    wrapper.has_run = False
    wrapper.result = None
    return wrapper
