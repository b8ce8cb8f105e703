"""PyTorch/CUDA port of the reference package ``repro``.

* StreamSim: ``run_many(specs, device="cuda")`` runs experiments on the
  GPU (pass ``device="cpu"`` to run them on the CPU).  Work-sharing and
  feedback cells the wave program's regime gate accepts run as
  whole-run programs, with the pump window assignment as a hand-written
  CUDA kernel; every other cell (the gate's refusals, among them every
  cell where the broker's credit flow or reject-publish overflow is
  reachable, and broadcast and broadcast+gather) runs on the per-cohort
  engine, ``TorchStreamSim``.  A chaos schedule (``SimParams.chaos``:
  link, broker and consumer outages, consumer autoscaling) runs its
  cell solo on that engine.
* Dense-transformer serving: ``models.zoo.build_model(cfg,
  device="cuda")``, ``launch.steps.build_prefill_step`` and
  ``launch.serve.generate``, with flash attention as a hand-written CUDA
  kernel (``ModelContext(attention_impl="pallas")``).

The package imports ``torch`` and NumPy only.
"""

from repro_torch.core.chaos import (
    VALID_KINDS, AutoscalePolicy, ChaosMetrics, ChaosSchedule, Injection,
    chaos_metrics, coerce_chaos, recovery_time)
from repro_torch.core.metrics import Summary, summarize, throughput_msgs_per_s
from repro_torch.core.run import STACK_MAX_LANES, run_many
from repro_torch.core.simulator import (
    ExperimentSpec, InfeasibleConfiguration, RunResult, SimParams)
from repro_torch.core.workloads import get_workload
