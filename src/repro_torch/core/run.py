"""``run_many``: the port's entry point for a batch of experiments.

The counterpart of the reference's ``vectorized.run_many`` for cells the
wave program takes: cells that differ only by seed stack into seed-lanes
of one run (at most :data:`STACK_MAX_LANES` per run), and structurally
identical runs share the cell axis of one program.  There is no
per-cohort engine in this package, so a cell the regime gate rejects
raises with the gate's reason instead of falling back.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import torch_device_loop as dl
from repro_torch.core.cell import WAVE_PATTERNS, WaveCell, _stack_key
from repro_torch.core.ds2hpc import ClusterInventory
from repro_torch.core.simulator import (
    ExperimentSpec, InfeasibleConfiguration, RunResult)
from repro_torch.device import resolve_device

#: stacked lanes per run are chunked to bound the array working set
STACK_MAX_LANES = 16


def run_many(specs: Sequence[ExperimentSpec], device: "torch.device | str" = "cuda",
             inventory: Optional[ClusterInventory] = None) -> list[RunResult]:
    """Run several experiments through the wave program on ``device``
    (the GPU unless the caller asks for ``"cpu"``).  Returns one
    :class:`RunResult` per spec, in input order; infeasible specs come
    back as ``feasible=False`` results.  Raises ``ValueError`` for a
    cell outside the wave regime and ``RuntimeError`` when ``device`` is
    CUDA and no GPU is available."""
    device = resolve_device(device)
    specs = list(specs)
    results: list = [None] * len(specs)
    groups: dict = {}
    for i, spec in enumerate(specs):
        if spec.pattern not in WAVE_PATTERNS:
            raise ValueError(f"pattern {spec.pattern!r} is not "
                             "wave-formulated")
        groups.setdefault(_stack_key(spec), []).append(i)
    runs: list = []
    for idxs in groups.values():
        for lo in range(0, len(idxs), STACK_MAX_LANES):
            chunk = idxs[lo:lo + STACK_MAX_LANES]
            try:
                cell = WaveCell(specs[chunk[0]], inventory, stack_seeds=[
                    specs[i].params.seed for i in chunk])
            except InfeasibleConfiguration as e:
                for i in chunk:
                    results[i] = RunResult(spec=specs[i], feasible=False,
                                           infeasible_reason=str(e))
                continue
            ok, why = dl._device_loop_ok(cell)
            if not ok:
                raise ValueError(f"cell outside the wave regime: {why}")
            runs.append((chunk, cell))
    lane_results = dl.run_wave_cells([cell for _, cell in runs], device)
    for (chunk, _), rs in zip(runs, lane_results):
        for i, r in zip(chunk, rs):
            results[i] = r
    return results
