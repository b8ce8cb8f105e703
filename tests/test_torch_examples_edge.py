"""``examples_torch/edge_to_hpc_training.py`` on the CPU, each run a
process of its own, beside ``examples/edge_to_hpc_training.py``.

A short run trains, crashes a consumer, writes its checkpoint at
``--steps`` and prints the reference's summary line.  Its exit follows
the example's own check, as the reference's does: 0 when the final loss
lies below the first, else ``AssertionError: training must make
progress``.  Over a few steps that is a coin toss in both packages, since
the streamed tokens are uniform (the loss starts near ln 8192 + 0.13 and
falls only after about 100 steps: 9.172 -> 9.067 over 200 steps on the
CPU), so the test holds the exit to the printed losses.  A second run in
the same directory resumes at ``--steps``, trains no step and fails on
the empty loss list, as the reference's does.
"""

import re
import shutil

from test_torch_examples import ROOT, run_script

SUMMARY = re.compile(r"^model: 104M params \| first loss (\d+\.\d{3}) -> "
                     r"final (\d+\.\d{3})$")


def _held_to_its_check(out, steps: int) -> None:
    """A first run: the step lines, the ``[fault]`` line, the summary,
    and the exit its own check gives."""
    lines = out.stdout.splitlines()
    assert f"[fault] crashed ingest-0 at step {steps // 3}; " in out.stdout
    assert lines[-2] == "", lines
    m = SUMMARY.match(lines[-1])
    assert m, lines
    if float(m.group(2)) < float(m.group(1)):
        assert out.returncode == 0, out.stderr
    else:
        assert out.returncode == 1
        assert out.stderr.rstrip().endswith(
            "AssertionError: training must make progress"), out.stderr


def _resumed_and_failed(out, ckpt, steps: int) -> None:
    """A second run in the same directory: resumed at ``steps``, no step
    trained, the summary's empty loss list raising."""
    assert out.stdout.splitlines() == [
        f"resumed from {ckpt / f'step_{steps:010d}'} at step {steps}"]
    assert out.returncode == 1
    assert out.stderr.rstrip().endswith("IndexError: list index out of "
                                        "range"), out.stderr


def test_edge_example_runs_and_resumes_as_the_reference(tmp_path):
    """The port at 4 steps, twice in one directory, and the reference at
    2 steps, twice in another: each first run held to its own check with
    its checkpoint at ``--steps`` (none at 50), each second run resumed
    there and failing alike."""
    port = ROOT / "examples_torch" / "edge_to_hpc_training.py"
    ref = ROOT / "examples" / "edge_to_hpc_training.py"
    for script, steps, extra in ((port, 4, ("--device", "cpu")),
                                 (ref, 2, ())):
        ckpt = tmp_path / script.parent.name
        args = ("--steps", str(steps), "--ckpt-dir", str(ckpt), *extra)
        try:
            _held_to_its_check(run_script(script, *args), steps)
            assert sorted(p.name for p in ckpt.iterdir()) == [
                f"step_{steps:010d}"]
            _resumed_and_failed(run_script(script, *args), ckpt, steps)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)    # 1.25 GB a run
