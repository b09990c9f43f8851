"""Smoke suite over every `examples/` script.

The examples are the L5 application layer — the re-designed mirror of the
reference's 9 notebooks (the reference's ONLY entry points) plus the
beyond-reference demos. Nothing else exercises them per-commit, which is
exactly how the reference rotted (SURVEY §2 defect list:
notebook-vs-library API drift). Each script runs in a subprocess on the
CPU backend at full problem size (measured 6-45 s each on this box) and
its golden prints are asserted: numeric goldens from the executed
reference notebooks where one exists (HEADTOHEAD.md), internal
consistency otherwise.

Slow-marked: runs in the slow suite (`pytest -m slow`), not the fast one.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")

# Each entry: script name -> list of checks. A check is either
#   ("has", substring)                      — stdout must contain it
#   ("float", regex_with_one_group, lo, hi) — first match parsed, bounded
# Regexes search the whole stdout. Bounds are deliberately loose where
# the quantity is stochastic (Monte-Carlo rates) and tight where a
# reference golden exists.
GOLDENS = {
    # reference notebook mirrors ------------------------------------------
    "double_integrator_control_bounds": [
        # golden 1.250e1 (Double integrator/LQR and SLS with control
        # bounds.ipynb; HEADTOHEAD rows 3-4)
        ("float", r"ADMM batch:\s+cost ([\d.e+-]+)", 12.49, 12.51),
        ("float", r"ADMM DP:\s+cost ([\d.e+-]+)", 12.49, 12.51),
        ("float", r"ADMM batch:.*max\|u\| ([\d.]+)", 4.99, 5.001),
        ("float", r"MC success SLS: ([\d.]+)", 90.0, 100.0),
    ],
    "double_integrator_state_bounds": [
        # golden 3.09e-2 (state-bounds notebook c18)
        ("float", r"batch: cost ([\d.e+-]+)", 3.08e-2, 3.10e-2),
        ("float", r"DP:\s+cost ([\d.e+-]+)", 3.08e-2, 3.10e-2),
        ("float", r"MC success SLS: ([\d.]+)", 80.0, 100.0),
    ],
    "double_integrator_obstacles": [
        ("float", r"unconstrained cost ([\d.e+-]+)", 2.45e-1, 2.50e-1),
        ("float", r"\nconstrained cost\s+([\d.e+-]+)", 2.6e-1, 2.8e-1),
        # projected iterate must clear both obstacles (radii 0.10/0.15)
        ("float", r"projected: min obstacle clearances ([\d.]+)", 0.10, 10.0),
    ],
    "car_control_bounds": [
        # golden 0.68766 (Car/Control bounded.ipynb c15)
        ("float", r"unconstrained iLQR: cost ([\d.]+)", 0.687, 0.689),
        ("float", r"ilqr_admm \|u\|<=0\.5: cost ([\d.]+)", 0.69, 0.71),
        ("float", r"max\|u\| ([\d.]+)", 0.0, 0.5001),
        ("has", "max|dA|=0.00e+00"),  # analytic == autodiff Jacobians
    ],
    "car_state_constraints": [
        ("float", r"\[consensus-ADMM\] constrained cost ([\d.]+)", 2.3, 2.8),
        ("float", r"\[exact single-push\] constrained cost ([\d.]+)", 2.3, 2.8),
        # both obstacle clearances >= the 1.25 half-width
        ("float",
         r"exact single-push.*?obstacle 0: ([\d.]+)", 1.25, 10.0),
    ],
    "arm_constrained": [
        # golden ~0.1996 (3DoF robot/State and control bound
        # constraints.ipynb); repo converges to 0.201
        ("float", r"constrained cost ([\d.]+)", 0.19, 0.21),
        ("float", r"final ee x ([\d.]+)", 0.499, 1.001),
    ],
    "arm_robust": [
        # reference workflow: non-robust 77.3 % / robust raises it
        ("float", r"non-robust cost ([\d.]+)", 0.11, 0.13),
        ("float", r"non-robust.*MC success ([\d.]+)", 70.0, 85.0),
        ("float", r"robust cost.*MC success ([\d.]+)", 80.0, 100.0),
        ("float", r"violating rows: (\d+)", 0, 0),
    ],
    "tutorial_car_parking": [
        # golden 0.9283 unconstrained (DDP-replicate c21 path)
        ("float", r"iLQR final cost ([\d.]+)", 0.925, 0.932),
        ("float", r"iLQR-ADMM final cost ([\d.]+)", 1.85, 2.0),
        ("float", r"max\|steer\| ([\d.]+)", 0.0, 0.5001),
    ],
    "mpc_car": [
        ("float", r"the car is at \[([\d.]+)", 1.95, 2.05),
        ("has", "fleet: one vmapped MPC tick for 16 controllers"),
    ],
    # beyond-reference demos ----------------------------------------------
    "boxddp_car_parking": [
        # single-instance golden 1.905 (reference ADMM path 1.903)
        ("float", r"boxDDP \|u1\|.*?cost ([\d.]+)", 1.89, 1.92),
        ("float", r"boxDDP \|u1\|.*?max\|u\| ([\d.]+) of bound", 0.0, 1.0001),
        ("float", r"parallel backward: cost ([\d.]+)", 1.89, 1.92),
    ],
    "admm_acceleration": [
        # all three drivers must reach the same constrained cost on the
        # well-scaled problem, anderson in fewer iterations than plain
        ("float", r"plain\s+:\s+\d+ iters\s+status=CONVERGED\s+cost=([\d.]+)",
         12.27, 12.29),
        ("float", r"anderson\(m=5\) :\s+(\d+) iters\s+status=CONVERGED", 1, 15),
    ],
    "al_obstacle_avoidance": [
        ("float", r"max violation ([\d.e+-]+)", 0.0, 1e-4),
        ("has", "min clearance"),
    ],
    "batched_multistart": [
        ("float", r"(\d+) instances solved", 4096, 4096),
        ("float", r"constraint-satisfaction rate \(psum-reduced\): ([\d.]+)",
         50.0, 100.0),
    ],
    "inverse_lqt_learning": [
        ("float", r"recovered: target=([\d.]+)", 0.69, 0.71),
        ("float", r"recovered: target=[\d.]+ \(true [\d.]+\), bound=([\d.]+)",
         2.45, 2.55),
        ("has", "OK"),
    ],
    "pd_ilqr_infeasible_start": [
        ("float", r"pd-ilqr\s*:\s*cost ([\d.]+)", 0.530, 0.534),
        ("float", r"max defect ([\d.e+-]+),", 0.0, 1e-5),
    ],
    "robust_fleet_diamond": [
        ("float", r"worst chance margin \+?(-?[\d.]+)", -1.0, 1e-3),
        ("float", r"bounds active for ([\d.]+)", 50.0, 100.0),
        ("has", "OK"),
    ],
    "robust_joint_calibration": [
        # joint MC success must meet the requested joint level
        ("float", r"joint MC success over 1000 rollouts: ([\d.]+)",
         0.958, 1.0),
    ],
    "sparse_control_l1": [
        ("float", r"l1 solution : (\d+)/100 timesteps active", 1, 40),
        ("float", r"l2 solution : (\d+)/100 timesteps active", 80, 100),
    ],
}


def _scripts():
    names = sorted(
        f[:-3] for f in os.listdir(EXAMPLES)
        if f.endswith(".py") and f != "README.py"
    )
    missing = set(names) - set(GOLDENS)
    extra = set(GOLDENS) - set(names)
    assert not missing, f"examples without golden checks: {missing}"
    assert not extra, f"golden checks without example script: {extra}"
    return names


@pytest.mark.slow
@pytest.mark.parametrize("name", _scripts())
def test_example_runs_and_matches_goldens(name):
    script = os.path.join(EXAMPLES, name + ".py")
    # subprocess: examples manage their own precision (some call
    # use_x64()), so they must NOT inherit this suite's in-process x64
    # config; the runpy wrapper pins the CPU backend before any JAX use.
    code = (
        "import jax; jax.config.update('jax_platforms','cpu')\n"
        "import runpy, sys\n"
        f"sys.argv = [{script!r}]\n"
        f"runpy.run_path({script!r}, run_name='__main__')\n"
    )
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)  # no 8-device virtual platform: examples
    # dispatch eagerly in places and 8 virtual devices slow them down
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=900, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, (
        f"{name} exited {proc.returncode}\nstdout:\n{proc.stdout[-3000:]}\n"
        f"stderr:\n{proc.stderr[-3000:]}"
    )
    out = proc.stdout
    for check in GOLDENS[name]:
        if check[0] == "has":
            assert check[1] in out, (
                f"{name}: expected {check[1]!r} in output\n{out[-3000:]}"
            )
        else:
            _, pattern, lo, hi = check
            m = re.search(pattern, out, re.DOTALL)
            assert m, f"{name}: no match for {pattern!r}\n{out[-3000:]}"
            val = float(m.group(1))
            assert lo <= val <= hi, (
                f"{name}: {pattern!r} -> {val} outside [{lo}, {hi}]\n"
                f"{out[-3000:]}"
            )
