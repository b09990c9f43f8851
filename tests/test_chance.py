"""Joint chance-constraint calibration API (`ilqr_admm_tpu.chance`).

The library (not a test helper) must turn a requested
*joint* confidence into per-row SOC data. Fast geometry/math tests here;
the end-to-end MC validations live in test_sls_robust.py /
test_isls_robust.py (slow).
"""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.stats import chi, norm

from ilqr_admm_tpu.chance import (
    calibrate,
    count_binding_rows,
    make_box_chance_projection,
    per_row_confidence,
    soc_box_rows,
)


class TestCalibrationMath:
    def test_chi_certificate_values(self):
        """chi calibration: psi = chi_p^{-1}(alpha), row-count free."""
        cal = calibrate(joint_alpha=0.95, robust_dim=1)
        assert abs(cal.psi_inv - chi.ppf(0.95, 1)) < 1e-12
        assert abs(cal.psi_inv - 1.96) < 0.01  # = two-sided normal quantile
        cal3 = calibrate(joint_alpha=0.958, robust_dim=3)
        assert abs(cal3.psi_inv - chi.ppf(0.958, 3)) < 1e-12
        # higher dimension needs a bigger ball at the same level
        assert cal3.psi_inv > cal.psi_inv

    def test_sidak_bonferroni(self):
        a_s = per_row_confidence(0.95, 200, "sidak")
        a_b = per_row_confidence(0.95, 200, "bonferroni")
        # both exceed the joint level; bonferroni (union bound) is the
        # more conservative (larger per-row level)
        assert 0.95 < a_s < a_b < 1.0
        # sidak is exact under independence: alpha_row^k == joint
        assert abs(a_s**200 - 0.95) < 1e-12
        cal = calibrate(joint_alpha=0.95, n_rows=100, sides=2, method="sidak")
        assert cal.n_constraints == 200
        assert abs(cal.psi_inv - norm.ppf(a_s)) < 1e-12

    def test_chi_beats_sidak_under_shared_uncertainty(self):
        """The certificate the reference workflow lacks: for shared
        initial-state uncertainty the chi ball gives a much smaller
        (feasibility-preserving) tightening than a per-row correction —
        measured on the DI fixture: sidak's psi=3.47 is infeasible
        (joint MC collapses to 0), chi's 1.96 delivers 0.9494."""
        chi_psi = calibrate(joint_alpha=0.95, robust_dim=1).psi_inv
        sidak_psi = calibrate(
            joint_alpha=0.95, n_rows=100, sides=2, method="sidak"
        ).psi_inv
        assert chi_psi < 2.0 < 3.4 < sidak_psi

    def test_errors(self):
        with pytest.raises(ValueError):
            per_row_confidence(1.5, 10)
        with pytest.raises(ValueError):
            per_row_confidence(0.9, 0)
        with pytest.raises(ValueError):
            per_row_confidence(0.9, 10, "wat")
        with pytest.raises(ValueError):
            calibrate()  # neither level
        with pytest.raises(ValueError):
            calibrate(joint_alpha=0.9, alpha_row=0.9, robust_dim=1)  # both
        with pytest.raises(ValueError):
            calibrate(joint_alpha=0.9)  # chi without robust_dim
        with pytest.raises(ValueError):
            calibrate(joint_alpha=0.9, method="sidak")  # sidak without n_rows
        with pytest.raises(ValueError):
            soc_box_rows(0.1, 2, None, None, 1.0)  # no sides


class TestProjectionGeometry:
    def test_projection_enforces_z_scores(self, rng):
        var, p, lo, hi = 0.1, 3, -6.0, 6.0
        proj, cal = make_box_chance_projection(var, p, lo, hi, alpha_row=0.99)
        rows = jnp.asarray(rng.normal(size=(40, p + 1)) * 2.0)
        out = np.asarray(proj(rows))
        spread = np.sqrt(var) * np.linalg.norm(out[:, 1:], axis=-1)
        z_hi = (hi - out[:, 0]) / np.maximum(spread, 1e-12)
        z_lo = (out[:, 0] - lo) / np.maximum(spread, 1e-12)
        assert z_hi.min() >= cal.psi_inv - 5e-2
        assert z_lo.min() >= cal.psi_inv - 5e-2

    def test_feasible_rows_are_fixed_points(self):
        proj, _ = make_box_chance_projection(0.1, 3, -6.0, 6.0, alpha_row=0.99)
        feas = jnp.asarray([[0.0, 0.1, 0.1, 0.1], [1.0, 0.0, 0.0, 0.0]])
        out = np.asarray(proj(feas))
        np.testing.assert_allclose(out, np.asarray(feas), atol=1e-6)

    def test_shifted_matches_unshifted_at_zero_nominal(self, rng):
        var, p = 0.05, 2
        kw = dict(joint_alpha=0.9, method="chi")
        proj_a, cal_a = make_box_chance_projection(var, p, -2.0, 2.0, **kw)
        proj_s, cal_s = make_box_chance_projection(
            var, p, -2.0, 2.0, shifted=True, **kw
        )
        assert cal_a == cal_s
        rows = jnp.asarray(rng.normal(size=(10, p + 1)))
        u_nom = jnp.zeros((10, 1))
        np.testing.assert_allclose(
            np.asarray(proj_s(rows, u_nom)), np.asarray(proj_a(rows)), atol=1e-12
        )

    def test_shifted_projection_shifts_feedforward_only(self, rng):
        """proj(y, u_nom) projects the ABSOLUTE feedforward y[:,0]+u_nom
        (reference `isls.py:641,649` semantics)."""
        var, p, hi = 0.04, 1, 1.0
        proj_s, cal = make_box_chance_projection(
            var, p, -hi, hi, alpha_row=0.9, shifted=True
        )
        # delta 0 + nominal 2.0 -> absolute 2.0 violates |u|<=1; the
        # projected delta must pull the absolute value into the SOC set
        y = jnp.zeros((1, p + 1)).at[0, 1].set(0.5)
        u_nom = jnp.full((1, 1), 2.0)
        out = np.asarray(proj_s(y, u_nom))
        ff_abs = out[0, 0] + 2.0
        spread = np.sqrt(var) * abs(out[0, 1])
        assert ff_abs <= hi - cal.psi_inv * spread + 5e-2

    def test_state_box_projection_rows(self, rng):
        """State-block helper: constrained rows land in their SOC sets
        (equality pins force [target | 0...0]), others pass through."""
        from ilqr_admm_tpu.chance import make_state_box_chance_projection

        N, d, p, var = 10, 2, 1, 0.02
        proj, cal = make_state_box_chance_projection(
            var, p, N, d,
            {(N - 1, 0): (0.5, 0.5), (N - 1, 1): (0.0, 0.0),
             (3, 0): (-1.0, 1.0)},
            joint_alpha=0.9, max_iter=100, threshold=1e-4,
        )
        y = jnp.asarray(rng.normal(size=(N * d, p + 1)) * 2.0)
        out = np.asarray(proj(y))
        # untouched rows pass through
        mask = np.ones(N * d, bool)
        for idx in ((N - 1) * d, (N - 1) * d + 1, 3 * d):
            mask[idx] = False
        np.testing.assert_allclose(out[mask], np.asarray(y)[mask])
        # equality pins: feedforward -> target, response -> ~0
        np.testing.assert_allclose(out[(N - 1) * d], [0.5, 0.0], atol=2e-2)
        np.testing.assert_allclose(out[(N - 1) * d + 1], [0.0, 0.0], atol=2e-2)
        # box row satisfies its z-score
        ff, phi = out[3 * d, 0], out[3 * d, 1]
        spread = np.sqrt(var) * abs(phi)
        assert min(1.0 - ff, ff + 1.0) >= cal.psi_inv * spread - 5e-2
        # bad row spec raises
        with pytest.raises(ValueError):
            make_state_box_chance_projection(
                var, p, N, d, {(N, 0): (0.0, 1.0)}, joint_alpha=0.9
            )

    def test_count_binding_rows(self):
        ff = np.asarray([0.0, 5.9, -5.9, 3.0])
        phi = np.asarray([[1.0], [0.05], [0.05], [0.0]])
        n = count_binding_rows(ff, phi, 0.1, -6.0, 6.0, psi_inv=2.0)
        # row 0: spread 0.316, z=19 -> not binding; rows 1/2: z ~ 6.3 ->
        # not binding at slack 0.25; row 3: zero spread -> never binds
        assert n == 1  # floor: max(n, 1)
        n2 = count_binding_rows(ff, phi * 20.0, 0.1, -6.0, 6.0, psi_inv=2.0)
        assert n2 >= 3


def test_direct_alpha_row_must_exceed_half():
    """alpha_row <= 0.5 would give psi_inv <= 0 and silently sign-flip /
    NaN the SOC sets built by soc_box_rows."""
    from ilqr_admm_tpu.chance import calibrate, make_box_chance_projection

    for bad in (0.5, 0.3, 0.0, -1.0):
        with pytest.raises(ValueError, match="alpha_row"):
            calibrate(alpha_row=bad, n_rows=10)
        with pytest.raises(ValueError, match="alpha_row"):
            make_box_chance_projection(0.1, 2, -1.0, 1.0, alpha_row=bad)
    # valid direct levels still pass
    cal = calibrate(alpha_row=0.9, n_rows=10)
    assert cal.psi_inv > 0
