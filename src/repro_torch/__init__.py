"""PyTorch/CUDA port of the reference package ``repro``.

* StreamSim: ``run_many(specs, device="cuda")`` and
  ``run_experiment(spec, device="cuda")`` run experiments on the GPU
  (pass ``device="cpu"`` to run them on the CPU), routed by
  ``SimParams.engine`` as the reference routes them.  Cells run on the
  per-cohort engine, ``TorchStreamSim``; a cell with ``engine="jax",
  jax_device_loop=True`` that the wave program's regime gate accepts
  runs as one whole-run program, with the pump window assignment as a
  hand-written CUDA kernel.  A chaos schedule (``SimParams.chaos``:
  link, broker and consumer outages, consumer autoscaling) runs its
  cell solo on the per-cohort engine.
* The heap engine, ``StreamSim`` (``engine="heap"``): the reference's
  one-event-per-hop model against its RabbitMQ broker model
  (``BrokerCluster``), which the parity bands are defined against.  It
  runs on the host, as its counterpart does; every entry point takes
  it, after resolving ``device``.
* The deployment machinery of the paper's §3–4: the SciStream control
  plane (``S2UC``, ``S2CS``, ``establish_prs_session``,
  ``provision_tenant_tunnels``), the S3M provisioning service
  (``S3MService``, ``ResourceSettings``) and the Helm release
  (``RabbitMQRelease``).
* The experiment layer, the reference's drivers with ``device=``
  added: ``run_pattern``, ``sweep``, ``overflow_stress``,
  ``multi_tenant``, ``deployment_feasibility``, ``chaos_campaign``,
  ``availability_crossover`` (``core/patterns.py``) and
  ``run_campaign`` (``core/campaign.py``).
* Dense-transformer serving: ``models.zoo.build_model(cfg,
  device="cuda")``, ``launch.steps.build_prefill_step`` and
  ``launch.serve.generate``, with flash attention as a hand-written CUDA
  kernel (``ModelContext(attention_impl="pallas")``).

The package imports ``torch`` and NumPy only.
"""

from repro_torch.core.architectures import (
    ALL_ARCHITECTURES, make_architecture)
from repro_torch.core.broker import BrokerCluster, ClassicQueue, Message
from repro_torch.core.chaos import (
    VALID_KINDS, AutoscalePolicy, ChaosMetrics, ChaosSchedule, Injection,
    chaos_metrics, coerce_chaos, recovery_time)
from repro_torch.core.campaign import (
    CampaignResult, CampaignSpec, CellSpec, cell_key, run_campaign)
from repro_torch.core.ds2hpc import ClusterInventory, RabbitMQRelease
from repro_torch.core.metrics import (
    Summary, jain_fairness, overhead_table, overhead_vs_baseline, rtt_cdf,
    rtt_fraction_under, summarize, tenant_median_rtts, tenant_throughputs,
    throughput_msgs_per_s)
from repro_torch.core.patterns import (
    CONSUMER_SWEEP, DEPLOYMENT_ARCHS, TENANT_SWEEP, AvailabilityStudy,
    ChaosPoint, FeasibilityStudy, TenantPoint, availability_crossover,
    chaos_campaign, chaos_cell, crossover_point, deployment_feasibility,
    multi_tenant, overflow_stress, pattern_spec, run_pattern, sweep)
from repro_torch.core.run import STACK_MAX_LANES, run_experiment, run_many
from repro_torch.core.s3m import ResourceSettings, S3MService
from repro_torch.core.scistream import (
    S2CS, S2UC, establish_prs_session, provision_tenant_tunnels)
from repro_torch.core.simulator import (
    ENGINES, Engine, ExperimentSpec, InfeasibleConfiguration, RunResult,
    SimConfig, SimParams, StreamSim, get_engine)
from repro_torch.core.workloads import get_workload
