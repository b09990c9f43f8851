"""CPU float64 oracles for the certified secondary benchmarks.

Runs as a SUBPROCESS of a GPU benchmark (`python benchmarks/_oracles.py
<task> in.npz out.npz`): the parent holds the card, this process runs
with JAX_PLATFORMS=cpu (`_certify.run_oracle`), pins the CPU backend +
x64 before any JAX use, and solves the certification problems in f64
with scipy — independent optimizers, not the repo's own solvers.

Tasks:
- boxddp_polish: bounded L-BFGS-B polish of car-parking boxDDP controls
  (nonconvex → the certificate is local optimality: a f64 second-order
  quality polish from the reported point must not find meaningfully
  lower cost).
- arm_polish: same for the 3DoF-arm iLQR-ADMM fleet (quadratic viapoint
  cost, nonlinear arm rollout, |u| <= bound box).
- sls_qp: EXACT convex oracle for the robust-SLS chance-constraint
  fleet: per instance, the QP over [du | phi] with the per-row
  |du_r| + c |phi_r| <= bound diamond written as 4 linear constraints,
  solved with scipy trust-constr; plus the exact diamond projection of
  the reported iterate (feasible z + primal residual).
"""

import sys

import numpy as np


def _pin_cpu_x64():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def boxddp_polish(data):
    from scipy.optimize import minimize

    jax = _pin_cpu_x64()
    import jax.numpy as jnp

    from ilqr_admm_tpu.models.car import CarFrontWheel, CarParkingCost
    from ilqr_admm_tpu.ops.rollout import rollout_nonlinear

    car = CarFrontWheel(dt=float(data["dt"]))
    cost = CarParkingCost()
    lo = np.asarray(data["lo"], np.float64)
    hi = np.asarray(data["hi"], np.float64)
    x0s = np.asarray(data["x0s"], np.float64)
    us = np.asarray(data["us"], np.float64)
    B, N, m = us.shape

    @jax.jit
    def j_fn(x0, u_flat):
        u = u_flat.reshape(N, m)
        xs = rollout_nonlinear(car.step, x0, u)
        return cost(xs, u)

    j_grad = jax.jit(jax.value_and_grad(j_fn, argnums=1))
    bounds = [(lo[k % m], hi[k % m]) for k in range(N * m)]

    j_ours = np.zeros(B)
    j_star = np.zeros(B)
    for i in range(B):
        u0 = np.clip(us[i].reshape(-1), np.tile(lo, N), np.tile(hi, N))
        j_ours[i] = float(j_fn(jnp.asarray(x0s[i]), jnp.asarray(u0)))

        def f_and_g(v, x0=jnp.asarray(x0s[i])):
            val, g = j_grad(x0, jnp.asarray(v))
            return float(val), np.asarray(g, np.float64)

        res = minimize(
            f_and_g, u0, jac=True, method="L-BFGS-B", bounds=bounds,
            options={"ftol": 1e-14, "gtol": 1e-10, "maxiter": 2000},
        )
        j_star[i] = min(res.fun, j_ours[i])
    return {"j_ours": j_ours, "j_star": j_star}


def arm_polish(data):
    from scipy.optimize import minimize

    jax = _pin_cpu_x64()
    import jax.numpy as jnp

    from ilqr_admm_tpu.models.arm import PlanarArm
    from ilqr_admm_tpu.ops.rollout import rollout_nonlinear
    from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost

    arm = PlanarArm(tuple(np.asarray(data["lengths"])), dt=float(data["dt"]))
    n = arm.q_dim
    zs = jnp.asarray(data["zs"], jnp.float64)
    Qs = jnp.asarray(data["Qs"], jnp.float64)
    seq = np.asarray(data["seq"], np.int32)
    u_std = float(data["u_std"])
    lo, hi = float(data["u_lo"]), float(data["u_hi"])
    q0s = np.asarray(data["q0s"], np.float64)
    us = np.asarray(data["us"], np.float64)
    B, N, m = us.shape
    quad = viapoint_cost(zs, Qs, seq, u_std, m)

    @jax.jit
    def j_fn(q0, u_flat):
        u = u_flat.reshape(N, m)
        x0 = jnp.concatenate([q0, jnp.zeros(n, jnp.float64), arm.fk(q0)])
        xs = rollout_nonlinear(arm.step, x0, u)
        return quad(xs, u)

    j_grad = jax.jit(jax.value_and_grad(j_fn, argnums=1))
    bounds = [(lo, hi)] * (N * m)

    j_ours = np.zeros(B)
    j_star = np.zeros(B)
    for i in range(B):
        u0 = np.clip(us[i].reshape(-1), lo, hi)
        j_ours[i] = float(j_fn(jnp.asarray(q0s[i]), jnp.asarray(u0)))

        def f_and_g(v, q0=jnp.asarray(q0s[i])):
            val, g = j_grad(q0, jnp.asarray(v))
            return float(val), np.asarray(g, np.float64)

        res = minimize(
            f_and_g, u0, jac=True, method="L-BFGS-B", bounds=bounds,
            options={"ftol": 1e-14, "gtol": 1e-10, "maxiter": 2000},
        )
        j_star[i] = min(res.fun, j_ours[i])
    return {"j_ours": j_ours, "j_star": j_star}


def _project_diamond(v, c, r):
    """Exact projection of rows v=(a, b) onto {|a| + c|b| <= r}.

    Weighted-l1-ball projection, vectorized over rows: soft-threshold
    v_i(l) = sign(v_i) max(|v_i| - l w_i, 0) with w = (1, c); the radius
    sum_i w_i |v_i(l)| is piecewise-linear decreasing in l, solved by
    bisection (64 steps ~ 2e-20 absolute accuracy)."""
    w = np.asarray([1.0, c])
    a = np.abs(v)
    need = a @ w > r
    out = v.copy()
    if not np.any(need):
        return out
    av = a[need]
    lo = np.zeros(av.shape[0])
    hi = np.max(av / w, axis=1)
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        radius = np.maximum(av - mid[:, None] * w, 0.0) @ w
        too_big = radius > r[need] if np.ndim(r) else radius > r
        lo = np.where(too_big, mid, lo)
        hi = np.where(too_big, hi, mid)
    lam = 0.5 * (lo + hi)
    out[need] = np.sign(v[need]) * np.maximum(av - lam[:, None] * w, 0.0)
    return out


def sls_qp(data):
    from scipy.optimize import LinearConstraint, minimize

    # pure numpy/scipy — no JAX needed for this convex quadratic task
    A = np.asarray(data["A"], np.float64)
    Bm = np.asarray(data["B"], np.float64)
    Q = np.asarray(data["Q"], np.float64)
    R = np.asarray(data["R"], np.float64)
    xd = np.asarray(data["xd"], np.float64)
    bounds = np.asarray(data["bounds"], np.float64)  # (B,) scenario bound
    U = np.asarray(data["U"], np.float64)  # (B, Nm, 2) reported [du, phi]
    c = float(data["c"])  # psi * sigma coefficient on |phi|

    sys.path.insert(0, ".")
    from ilqr_admm_tpu.ops.lifted import build_Su, build_Sx
    from ilqr_admm_tpu.solvers.lqt import block_diag_stacked

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    Su = np.asarray(build_Su(A, Bm), np.float64)
    Sx = np.asarray(build_Sx(A, 1), np.float64).reshape(-1, 1)[:, 0]
    Ql = np.asarray(block_diag_stacked(np.asarray(Q, np.float64)))
    Rl = np.asarray(block_diag_stacked(np.asarray(R, np.float64)))
    Nm = Su.shape[1]

    # J(du, phi) = (Su du - xd)' Q (Su du - xd) + du' R du
    #            + (Su phi + Sx)' Q (Su phi + Sx) + phi' R phi
    H = Su.T @ Ql @ Su + Rl  # shared curvature of both columns
    g_du = -Su.T @ (Ql @ xd)
    g_phi = Su.T @ (Ql @ Sx)
    const_du = xd @ Ql @ xd
    const_phi = Sx @ Ql @ Sx

    def j_of(du, phi):
        return (
            du @ H @ du + 2 * g_du @ du + const_du
            + phi @ H @ phi + 2 * g_phi @ phi + const_phi
        )

    # 4 linear constraints per row encode |du_r| + c |phi_r| <= bound
    signs = [(1, 1), (1, -1), (-1, 1), (-1, -1)]
    rows = []
    for sa, sb in signs:
        Arow = np.zeros((Nm, 2 * Nm))
        Arow[:, :Nm] = sa * np.eye(Nm)
        Arow[:, Nm:] = sb * c * np.eye(Nm)
        rows.append(Arow)
    A_con = np.concatenate(rows, axis=0)

    Hfull = np.zeros((2 * Nm, 2 * Nm))
    Hfull[:Nm, :Nm] = H
    Hfull[Nm:, Nm:] = H
    gfull = np.concatenate([g_du, g_phi])

    Bsz = U.shape[0]
    j_z = np.zeros(Bsz)
    j_star = np.zeros(Bsz)
    prim = np.zeros(Bsz)
    for i in range(Bsz):
        r = float(bounds[i])
        z = _project_diamond(U[i], c, r)  # exact feasible iterate
        prim[i] = float(np.linalg.norm(U[i] - z))
        j_z[i] = j_of(z[:, 0], z[:, 1])

        def f(v):
            return v @ Hfull @ v + 2 * gfull @ v + const_du + const_phi

        def jac(v):
            return 2 * (Hfull @ v + gfull)

        v0 = z.T.reshape(-1)  # [du; phi], feasible start
        res = minimize(
            f, v0, jac=jac, method="trust-constr",
            hess=lambda v: 2 * Hfull,
            constraints=[LinearConstraint(A_con, -np.inf, r)],
            options={"gtol": 1e-12, "xtol": 1e-14, "maxiter": 3000},
        )
        j_star[i] = min(res.fun, j_z[i])
    return {"j_z": j_z, "j_star": j_star, "prim": prim}


TASKS = {
    "boxddp_polish": boxddp_polish,
    "arm_polish": arm_polish,
    "sls_qp": sls_qp,
}


def main():
    task, f_in, f_out = sys.argv[1], sys.argv[2], sys.argv[3]
    data = dict(np.load(f_in, allow_pickle=False))
    out = TASKS[task](data)
    np.savez(f_out, **out)


if __name__ == "__main__":
    import os

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    main()
