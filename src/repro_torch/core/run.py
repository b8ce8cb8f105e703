"""``run_many``: the port's entry point for a batch of experiments.

The counterpart of the reference's ``vectorized.run_many``.  Cells that
differ only by seed stack into seed-lanes of one run (at most
:data:`STACK_MAX_LANES` per run).  A work-sharing or feedback cell that
the wave program's regime gate accepts goes to the wave program, and
structurally identical wave runs share the cell axis of one program;
every other cell (the gate's refusals, among them every cell where the
broker's credit flow or reject-publish overflow is reachable, and
broadcast and broadcast+gather) goes to the per-cohort engine,
:class:`TorchStreamSim`, which reports each lane's rejected publishes
and withheld confirms.  A chaos cell (``params.chaos``) never stacks and
the wave gate refuses it: each runs solo on the per-cohort engine.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import torch_device_loop as dl
from repro_torch.core.cell import WAVE_PATTERNS, WaveCell, _stack_key
from repro_torch.core.ds2hpc import ClusterInventory
from repro_torch.core.simulator import (
    ExperimentSpec, InfeasibleConfiguration, RunResult)
from repro_torch.core.torch_engine import TorchStreamSim
from repro_torch.device import resolve_device

#: stacked lanes per run are chunked to bound the array working set
STACK_MAX_LANES = 16


def run_many(specs: Sequence[ExperimentSpec], device: "torch.device | str" = "cuda",
             inventory: Optional[ClusterInventory] = None) -> list[RunResult]:
    """Run several experiments on ``device`` (the GPU unless the caller
    asks for ``"cpu"``).  Returns one :class:`RunResult` per spec, in
    input order; infeasible specs come back as ``feasible=False``
    results.  Raises ``ValueError`` for an unknown pattern, and
    ``RuntimeError`` when ``device`` is CUDA and no GPU is available."""
    device = resolve_device(device)
    specs = list(specs)
    results: list = [None] * len(specs)
    groups: dict = {}
    for i, spec in enumerate(specs):
        groups.setdefault(_stack_key(spec, i), []).append(i)
    waves: list = []
    for idxs in groups.values():
        for lo in range(0, len(idxs), STACK_MAX_LANES):
            chunk = idxs[lo:lo + STACK_MAX_LANES]
            spec = specs[chunk[0]]
            seeds = [specs[i].params.seed for i in chunk]
            try:
                if spec.pattern in WAVE_PATTERNS:
                    cell = WaveCell(spec, inventory, stack_seeds=seeds)
                    if dl._device_loop_ok(cell)[0]:
                        waves.append((chunk, cell))
                        continue
                sim = TorchStreamSim(spec, inventory, stack_seeds=seeds,
                                     device=device)
            except InfeasibleConfiguration as e:
                for i in chunk:
                    results[i] = RunResult(spec=specs[i], feasible=False,
                                           infeasible_reason=str(e))
                continue
            for i, r in zip(chunk, sim.run_stacked()):
                results[i] = r
    lane_results = dl.run_wave_cells([cell for _, cell in waves], device)
    for (chunk, _), rs in zip(waves, lane_results):
        for i, r in zip(chunk, rs):
            results[i] = r
    return results
