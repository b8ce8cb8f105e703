"""``examples_torch/cross_facility_comparison.py`` held to
``examples/cross_facility_comparison.py`` on the CPU: the standard output
of each, run in a process of its own, equal line for line on the
vectorized engine (the port's per-cohort engine) and on the heap engine.
"""

import pytest

from test_torch_examples import ROOT, run_script


@pytest.mark.parametrize("engine", ["vectorized", "heap"])
def test_comparison_prints_the_reference_lines(engine):
    want = run_script(ROOT / "examples" / "cross_facility_comparison.py",
                      "--engine", engine)
    got = run_script(ROOT / "examples_torch" / "cross_facility_comparison.py",
                     "--engine", engine, "--device", "cpu")
    assert want.returncode == 0, want.stderr
    assert got.returncode == 0, got.stderr
    assert got.stdout.splitlines() == want.stdout.splitlines()
    assert len(got.stdout.splitlines()) == 28
