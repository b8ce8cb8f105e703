"""Every ``shapes_for`` cell of gemma2-9b, granite-3-8b and
moonshot-v1-16b-a3b under ``run_cell`` on the fake 512-rank ``multi``
world at one scan unit (``_dryrun_cells.check_arch``: each record OK, no
process group left open, its costs, memory and roofline held)."""

import pytest

from _dryrun_cells import check_arch


@pytest.mark.parametrize(
    "arch",
    ('gemma2-9b',
     'granite-3-8b',
     'moonshot-v1-16b-a3b'))
def test_every_cell_on_the_two_pod_world(arch):
    check_arch(arch, "multi")
