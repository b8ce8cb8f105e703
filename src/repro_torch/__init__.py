"""PyTorch/CUDA port of the reference package ``repro``.

* StreamSim's wave program: ``run_many(specs, device="cuda")`` runs
  work-sharing and feedback experiments as whole-run programs on the GPU
  (pass ``device="cpu"`` to run them on the CPU), with the pump window
  assignment as a hand-written CUDA kernel.
* Dense-transformer serving: ``models.zoo.build_model(cfg,
  device="cuda")``, ``launch.steps.build_prefill_step`` and
  ``launch.serve.generate``, with flash attention as a hand-written CUDA
  kernel (``ModelContext(attention_impl="pallas")``).

The package imports ``torch`` and NumPy only.
"""

from repro_torch.core.metrics import Summary, summarize, throughput_msgs_per_s
from repro_torch.core.run import STACK_MAX_LANES, run_many
from repro_torch.core.simulator import (
    ExperimentSpec, InfeasibleConfiguration, RunResult, SimParams)
from repro_torch.core.workloads import get_workload
