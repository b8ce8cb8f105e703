"""Every ``shapes_for`` cell of qwen3-moe-30b-a3b, pixtral-12b and
xlstm-1.3b under ``run_cell`` on the fake 512-rank ``multi`` world at
one scan unit (``_dryrun_cells.check_arch``: each record OK, no process
group left open, its costs, memory and roofline held)."""

import pytest

from _dryrun_cells import check_arch


@pytest.mark.parametrize(
    "arch",
    ('qwen3-moe-30b-a3b',
     'pixtral-12b',
     'xlstm-1.3b'))
def test_every_cell_on_the_two_pod_world(arch):
    check_arch(arch, "multi")
