"""``run_many`` and ``run_experiment``: the port's entry points for
experiments.

The counterparts of the reference's ``vectorized.run_many`` and
``simulator.run_experiment``, routing each cell by
``params.engine`` as the reference does:

* ``"vectorized"`` and ``"jax"`` cells run on the per-cohort engine,
  :class:`TorchStreamSim` (the reference's event loop, every lane's
  clocks on the device), which reports each lane's rejected publishes
  and withheld confirms;
* a ``"jax"`` cell with ``params.jax_device_loop`` set runs on the
  whole-run wave program instead, when the wave program's regime gate
  (``torch_device_loop._device_loop_ok``) accepts it: work sharing or
  feedback with no flow-control events reachable.  Structurally
  identical wave runs share the cell axis of one program;
* a ``"jax"`` chaos cell (``params.chaos``) is rewritten to
  ``"vectorized"`` in ``run_many``, as the reference's ``run_many`` does
  (:func:`jax_supported`), and raises in ``run_experiment``, as the
  reference's jax engine does;
* ``"heap"`` cells run on the heap engine,
  :class:`~repro_torch.core.simulator.StreamSim`, the one-event-per-hop
  model the parity bands are defined against.  It runs on the host, as
  its counterpart in the reference does: ``device`` is still resolved
  first (``"cuda"`` without a GPU raises), and no other engine's cell is
  ever sent to it, nor a heap cell to another engine.

In ``run_many``, cells that differ only by seed stack into seed-lanes of
one run (at most :data:`STACK_MAX_LANES` per run); a chaos cell never
stacks and runs solo on the per-cohort engine, and a heap cell runs
solo, as the reference groups them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import torch_device_loop as dl
from repro_torch.core.architectures import Architecture
from repro_torch.core.cell import WAVE_PATTERNS, WaveCell, _stack_key
from repro_torch.core.ds2hpc import ClusterInventory
from repro_torch.core.simulator import (
    ExperimentSpec, InfeasibleConfiguration, RunResult, StreamSim)
from repro_torch.core.torch_engine import TorchStreamSim
from repro_torch.device import resolve_device

#: stacked lanes per run are chunked to bound the array working set
STACK_MAX_LANES = 16


def jax_supported(spec: ExperimentSpec) -> tuple[bool, str]:
    """Can a ``"jax"`` cell stay on the jax engine?  ``(ok, reason)``, as
    the reference's ``jax_engine.jax_supported`` answers it where jax is
    importable: every cell but a chaos cell, which falls back to the
    vectorized engine."""
    if spec.params.chaos is not None:
        return False, ("chaos schedules mutate topology mid-run; the "
                       "jax depart-store kernels are static — falling "
                       "back to the vectorized engine")
    return True, ""


def _run(specs: list, device: torch.device,
         inventory: Optional[ClusterInventory],
         arch: Optional[Architecture]) -> list[RunResult]:
    """Group, route and run ``specs`` (engine names already resolved)."""
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
                if spec.params.engine == "heap":
                    (i,) = chunk
                    results[i] = StreamSim(spec, inventory, arch).run()
                    continue
                if (spec.params.engine == "jax"
                        and spec.params.jax_device_loop
                        and spec.pattern in WAVE_PATTERNS):
                    cell = WaveCell(spec, inventory, arch, stack_seeds=seeds)
                    if dl._device_loop_ok(cell)[0]:
                        waves.append((chunk, cell))
                        continue
                sim = TorchStreamSim(spec, inventory, arch,
                                     stack_seeds=seeds, device=device)
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


def run_many(specs: Sequence[ExperimentSpec], device: "torch.device | str" = "cuda",
             inventory: Optional[ClusterInventory] = None) -> list[RunResult]:
    """Run several experiments on ``device`` (the GPU unless the caller
    asks for ``"cpu"``).  ``engine="jax"`` cells that
    :func:`jax_supported` refuses run as ``"vectorized"``, recorded per
    cell in the result's ``spec.params.engine``.  Returns one
    :class:`RunResult` per spec, in input order; infeasible specs come
    back as ``feasible=False`` results.  Heap-engine cells run solo on
    the host.  Raises ``ValueError`` for an unknown pattern and
    ``RuntimeError`` when ``device`` is CUDA and no GPU is available."""
    device = resolve_device(device)
    specs = list(specs)
    for i, spec in enumerate(specs):
        if spec.params.engine == "jax" and not jax_supported(spec)[0]:
            specs[i] = dataclasses.replace(
                spec, params=dataclasses.replace(spec.params,
                                                 engine="vectorized"))
    return _run(specs, device, inventory, None)


def run_experiment(spec: ExperimentSpec,
                   inventory: Optional[ClusterInventory] = None,
                   arch: Optional[Architecture] = None,
                   device: "torch.device | str" = "cuda") -> RunResult:
    """Run one experiment on the engine named by ``spec.params.engine``,
    on ``device`` (the GPU unless the caller asks for ``"cpu"``);
    infeasible configs return a RunResult with feasible=False (matching
    the paper's missing Stunnel data points).  ``arch`` is an
    architecture built by the caller (a custom calibration).  A
    ``"heap"`` cell runs on the host, after ``device`` is resolved."""
    device = resolve_device(device)
    if spec.params.engine == "jax" and spec.params.chaos is not None:
        raise ValueError(
            "engine='jax' does not support chaos schedules (the "
            "depart-store kernels are static); use "
            "engine='vectorized' (run_many falls back automatically)")
    return _run([spec], device, inventory, arch)[0]
