"""Hetis core: the paper's contribution as hardware-agnostic algorithms.

Modules:
  cluster      — heterogeneous device inventory (ClusterSpec / DeviceClass)
  costmodel    — HexGen-style C_comp + C_comm analytic model (§4.1)
  profiler     — Eq (3)/(4) linear models + fitting / measurement (§5.1)
  parallelizer — hierarchical sigma* search for primary workers (§4.1)
  dispatcher   — online min-max LP head dispatching + re-dispatching (§5)
  hauler       — head-granular cache migration planning (§6)

Copies of ``repro.core``'s framework-free code: the port imports nothing
of ``repro``, so the scheduling policy is pinned to the reference by the
parity tests instead.
"""

from repro_torch.core.cluster import ClusterSpec, Device, DeviceClass, DEVICE_CLASSES
from repro_torch.core.costmodel import (ModelProfile, PAPER_MODELS,
                                        StageConfig)
from repro_torch.core.dispatcher import (AttnRequest, WorkerState,
                                         apply_placement, dispatch_lp,
                                         grow_context,
                                         handle_memory_exhaustion,
                                         handle_worker_failure,
                                         ideal_attention_time,
                                         maybe_rebalance, release_request)
from repro_torch.core.hauler import (MigrationScheduler, MigrationTask,
                                     migration_bytes, plan_migration)
from repro_torch.core.parallelizer import (ParallelPlan,
                                           RequestDistribution, search)
from repro_torch.core.profiler import (AttentionModel, TransferModel,
                                       analytic_attention_model,
                                       analytic_transfer_model,
                                       fit_attention_model,
                                       fit_transfer_model, profile_attention)
