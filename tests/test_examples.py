"""Examples gated in the suite: each ``examples/*.py`` runs
end-to-end as a subprocess at a reduced budget (``SMOKE=1``), so a break in
any example API it exercises fails CI instead of going unnoticed.

Subprocesses keep each example's own jax config (platform/x64/virtual-device
flags) isolated from the suite's.
"""
import os
import subprocess
import sys

import pytest

EXAMPLES_DIR = os.path.join(os.path.dirname(__file__), "..", "examples")

EXAMPLES = [
    "intro_example.py",
    "ibr_example.py",
    "long_horizon_example.py",
    "nullspace_example.py",
    "quadrotor_example.py",
    "roundabout_example.py",
]

# A line each example prints only after its solve completed — the smoke run
# asserts the example got past its numerical core, not just that it imported.
MARKERS = {
    "intro_example.py": "violations:",
    "ibr_example.py": "max trajectory difference Nash vs IBR",
    "long_horizon_example.py": "x_spike - x_sequential",
    "nullspace_example.py": "nullspace dimension:",
    "quadrotor_example.py": "violations:",
    "roundabout_example.py": "min pairwise distance:",
}


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_smoke(name):
    env = dict(os.environ, SMOKE="1")
    env.pop("XLA_FLAGS", None)   # let each example set its own device count
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES_DIR, name)],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, (
        f"{name} failed (rc={proc.returncode})\n--- stdout ---\n"
        f"{proc.stdout[-3000:]}\n--- stderr ---\n{proc.stderr[-3000:]}")
    assert MARKERS[name] in proc.stdout, (
        f"{name} ran but its completion marker {MARKERS[name]!r} is missing"
        f"\n--- stdout ---\n{proc.stdout[-3000:]}")
