"""Mesh-parallel consensus-ADMM block tests (SURVEY §2.3 row 4).

The reference's `project_set_convex` (`projections.py:289-374`) loops
over constraint blocks sequentially; this build partitions the
stacked (A_i, b_i) blocks over a ('consensus',) mesh axis with the
consensus aggregate psum'd per iteration. Oracle chain:
list form == stacked form == 8-device sharded form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from ilqr_admm_tpu.parallel.consensus import (
    project_set_convex_sharded,
    project_set_convex_stacked,
)
from ilqr_admm_tpu.projections import (
    project_bound,
    project_set_convex,
    project_soc_unit,
)


def _consensus_mesh(n=8):
    return Mesh(np.array(jax.devices()[:n]), ("consensus",))


def _random_soc_blocks(rng, nb, m, dim):
    As = 0.3 * rng.standard_normal((nb, m, dim))
    bs = rng.standard_normal((nb, m)) * 0.2 + np.array([0.0] * (m - 1) + [1.0])
    return jnp.asarray(As), jnp.asarray(bs)


def _chance_soc_blocks():
    """The state-bounds chance-constraint pair (reference notebook c16):
    two SOCs per decision row [du | phi]."""
    psi_inv = 1.2815515655446004  # norm.ppf(0.9)
    mu = np.array([0.0, 0.3])
    sig = np.diag(np.sqrt([0.0, 0.02]))
    A_hi = np.concatenate([sig, (-mu / psi_inv)[None]], axis=0)
    b_hi = np.array([0.0, 0.0, 5.0 / psi_inv])
    A_lo = np.concatenate([sig, (mu / psi_inv)[None]], axis=0)
    b_lo = np.array([0.0, 0.0, 5.0 / psi_inv])
    return jnp.asarray(np.stack([A_hi, A_lo])), jnp.asarray(np.stack([b_hi, b_lo]))


def test_stacked_matches_list_form(rng):
    """Stacked-block consensus ADMM == the reference-shaped list form on
    the chance-constraint SOC intersection."""
    As, bs = _chance_soc_blocks()
    y = jnp.asarray(rng.standard_normal((40, 2)) * 3.0)

    ref = project_set_convex(
        y, [As[0], As[1]], [bs[0], bs[1]],
        [project_soc_unit, project_soc_unit], rho=1e1, max_iter=50,
        threshold=1e-6,
    )
    got = project_set_convex_stacked(
        y, As, bs, project_soc_unit, rho=1e1, max_iter=50, threshold=1e-6
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-10)


def test_sharded_matches_stacked_with_padding(rng):
    """nb=2 blocks on an 8-device ('consensus',) mesh: zero-padded blocks
    must not perturb the iterates; sharded == single-device stacked."""
    As, bs = _chance_soc_blocks()
    y = jnp.asarray(rng.standard_normal((16, 2)) * 3.0)
    mesh = _consensus_mesh()

    ref = project_set_convex_stacked(
        y, As, bs, project_soc_unit, rho=1e1, max_iter=50, threshold=1e-6
    )
    got = project_set_convex_sharded(
        y, As, bs, project_soc_unit, rho=1e1, max_iter=50, threshold=1e-6,
        mesh=mesh,
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-9)


def test_sharded_matches_stacked_full_axis(rng):
    """nb=8 random SOC blocks, one per device; batched points."""
    As, bs = _random_soc_blocks(rng, nb=8, m=3, dim=4)
    y = jnp.asarray(rng.standard_normal((5, 4)))
    mesh = _consensus_mesh()

    ref = project_set_convex_stacked(
        y, As, bs, project_soc_unit, rho=2.0, max_iter=80, threshold=1e-8
    )
    got = project_set_convex_sharded(
        y, As, bs, project_soc_unit, rho=2.0, max_iter=80, threshold=1e-8,
        mesh=mesh,
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-9)
    # the projection actually constrains: moved points satisfy the SOCs
    fr = jnp.einsum("smj,bj->sbm", As, got) + bs[:, None]
    t, v = fr[..., -1], fr[..., :-1]
    assert float(jnp.max(jnp.linalg.norm(v, axis=-1) - t)) < 1e-3


def test_sharded_heterogeneous_blocks(rng):
    """Mixed constraint types dispatch on the global block index
    (projection(y, idx) signature) — SOC blocks + box blocks."""
    As, bs = _random_soc_blocks(rng, nb=4, m=3, dim=3)
    # blocks 2,3: plain box on the frame coordinates
    As = As.at[2:].set(jnp.stack([jnp.eye(3)] * 2))
    bs = bs.at[2:].set(0.0)

    def proj(y, idx):
        def one(y_i, i):
            return jax.lax.switch(
                jnp.where(i < 2, 0, 1),
                [project_soc_unit, lambda v: project_bound(v, -0.8, 0.8)],
                y_i,
            )

        return jax.vmap(one)(y, idx)

    y = jnp.asarray(rng.standard_normal((6, 3)) * 2.0)
    mesh = _consensus_mesh()
    ref = project_set_convex_stacked(
        y, As, bs, proj, rho=1.5, max_iter=100, threshold=1e-8
    )
    got = project_set_convex_sharded(
        y, As, bs, proj, rho=1.5, max_iter=100, threshold=1e-8, mesh=mesh
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-9)
    assert float(jnp.max(jnp.abs(got))) <= 0.8 + 1e-3  # box blocks active


def test_sharded_unbatched_point(rng):
    As, bs = _chance_soc_blocks()
    y = jnp.asarray(rng.standard_normal(2) * 4.0)
    mesh = _consensus_mesh()
    ref = project_set_convex_stacked(
        y, As, bs, project_soc_unit, rho=1e1, max_iter=50, threshold=1e-8
    )
    got = project_set_convex_sharded(
        y, As, bs, project_soc_unit, rho=1e1, max_iter=50, threshold=1e-8,
        mesh=mesh,
    )
    assert got.shape == (2,)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-9)
