"""Hetis core algorithms, as the serving engine uses them.

Modules:
  cluster      — heterogeneous device inventory (ClusterSpec / DeviceClass)
  costmodel    — the ModelProfile and dense-FLOP count of the §4.1 model
  profiler     — Eq (3)/(4) linear models + fitting / measurement (§5.1)
  dispatcher   — online min-max LP head dispatching + re-dispatching (§5)
  hauler       — head-granular cache migration planning (§6)

Copies of ``repro.core``'s framework-free code: the port imports nothing
of ``repro``, so the scheduling policy is pinned to the reference by the
parity tests instead.
"""

from repro_torch.core.cluster import ClusterSpec, Device, DeviceClass, DEVICE_CLASSES
from repro_torch.core.costmodel import ModelProfile
from repro_torch.core.dispatcher import (AttnRequest, WorkerState,
                                         apply_placement, dispatch_lp,
                                         grow_context,
                                         handle_memory_exhaustion,
                                         maybe_rebalance, release_request)
from repro_torch.core.hauler import (MigrationScheduler, MigrationTask,
                                     migration_bytes, plan_migration)
from repro_torch.core.profiler import (AttentionModel, TransferModel,
                                       analytic_attention_model,
                                       analytic_transfer_model,
                                       fit_attention_model,
                                       fit_transfer_model, profile_attention)
