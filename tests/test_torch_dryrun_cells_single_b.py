"""Every ``shapes_for`` cell of zamba2-7b, moonshot-v1-16b-a3b,
qwen3-moe-30b-a3b, xlstm-1.3b and pixtral-12b under ``run_cell`` on the
fake 256-rank ``single`` world at one scan unit
(``_dryrun_cells.check_arch``: each record OK, no process group left
open, its costs, memory and roofline held)."""

import pytest

from _dryrun_cells import check_arch


@pytest.mark.parametrize(
    "arch",
    ('zamba2-7b',
     'moonshot-v1-16b-a3b',
     'qwen3-moe-30b-a3b',
     'xlstm-1.3b',
     'pixtral-12b'))
def test_every_cell_on_the_single_pod_world(arch):
    check_arch(arch, "single")
