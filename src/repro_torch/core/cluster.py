"""Heterogeneous cluster description.

The paper's algorithms (Parallelizer / Dispatcher / Hauler) are hardware
agnostic: every decision is made against a :class:`ClusterSpec`, which lists
devices by *class*.  Device classes carry the constants that the cost models
(``core/costmodel.py``) and the profiler's linear models (``core/profiler.py``)
need: dense throughput, memory bandwidth, memory capacity, and link bandwidth.

We ship calibrated specs for the paper's cluster (A100-80GB / RTX-3090 /
P100) plus TPU generations so the same algorithms run against a heterogeneous
TPU fleet (v5e / v4 / v3 slices), which is the realistic TPU analogue of a
mixed GPU datacenter.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class DeviceClass:
    """Performance envelope of one accelerator type.

    Attributes
    ----------
    name: class identifier ("A100", "P100", "v5e", ...)
    dense_tflops: achievable dense matmul throughput (bf16/fp16), TFLOP/s.
        This is *effective* (not peak marketing) — used for dense modules.
    hbm_gbps: memory bandwidth, GB/s.  Decode Attention is bandwidth bound,
        so this dominates the attention-time slope ``b_i`` in Eq (3).
    mem_gb: device memory capacity, GB.
    intra_link_gbps: intra-host interconnect per direction, GB/s (NVLink or
        PCIe for GPUs, ICI for TPUs).
    inter_link_gbps: cross-host network per device, GB/s (100 Gbps LAN =
        12.5 GB/s in the paper; DCN for TPU pods).
    launch_overhead_us: fixed per-kernel / per-step overhead (the ``c_i``
        intercept of Eq (3)).
    """

    name: str
    dense_tflops: float
    hbm_gbps: float
    mem_gb: float
    intra_link_gbps: float = 12.0
    inter_link_gbps: float = 12.5
    launch_overhead_us: float = 30.0

    # -- derived helpers ---------------------------------------------------
    def dense_s(self, flops: float, efficiency: float = 0.55) -> float:
        """Seconds to execute ``flops`` of dense matmul work."""
        return flops / (self.dense_tflops * 1e12 * efficiency)

    def hbm_s(self, bytes_moved: float, efficiency: float = 0.75) -> float:
        """Seconds to stream ``bytes_moved`` through HBM."""
        return bytes_moved / (self.hbm_gbps * 1e9 * efficiency)


# Calibration notes
# -----------------
# GPU numbers are set so that the OPT-2.7B iteration times of Table 1 and the
# Llama-70B module gaps of Fig. 2 are reproduced by core/costmodel.py
# (see tests/test_costmodel.py::test_table1_gaps).  P100 has no tensor cores,
# so its effective fp16 dense throughput is its fp32 FMA rate (~9.5 TFLOP/s
# with ~0.35 efficiency) — this is what produces the paper's 24.5x prefill gap.
DEVICE_CLASSES: Dict[str, DeviceClass] = {
    "A100": DeviceClass("A100", dense_tflops=312.0, hbm_gbps=2039.0, mem_gb=80.0,
                        intra_link_gbps=25.0, inter_link_gbps=12.5,
                        launch_overhead_us=25.0),
    "3090": DeviceClass("3090", dense_tflops=142.0, hbm_gbps=936.0, mem_gb=24.0,
                        intra_link_gbps=12.0, inter_link_gbps=12.5,
                        launch_overhead_us=30.0),
    "P100": DeviceClass("P100", dense_tflops=19.0, hbm_gbps=732.0, mem_gb=12.0,
                        intra_link_gbps=10.0, inter_link_gbps=12.5,
                        launch_overhead_us=45.0,),
    "H100": DeviceClass("H100", dense_tflops=989.0, hbm_gbps=3350.0, mem_gb=80.0,
                        intra_link_gbps=45.0, inter_link_gbps=25.0,
                        launch_overhead_us=20.0),
    "L4": DeviceClass("L4", dense_tflops=121.0, hbm_gbps=300.0, mem_gb=24.0,
                      intra_link_gbps=8.0, inter_link_gbps=12.5,
                      launch_overhead_us=30.0),
    # TPU generations — ICI per-link ~50 GB/s (v5e), DCN across pods.
    "v5e": DeviceClass("v5e", dense_tflops=197.0, hbm_gbps=819.0, mem_gb=16.0,
                       intra_link_gbps=50.0, inter_link_gbps=25.0,
                       launch_overhead_us=15.0),
    "v4": DeviceClass("v4", dense_tflops=275.0, hbm_gbps=1228.0, mem_gb=32.0,
                      intra_link_gbps=50.0, inter_link_gbps=25.0,
                      launch_overhead_us=15.0),
    "v3": DeviceClass("v3", dense_tflops=123.0, hbm_gbps=900.0, mem_gb=16.0,
                      intra_link_gbps=35.0, inter_link_gbps=25.0,
                      launch_overhead_us=20.0),
}


@dataclasses.dataclass(frozen=True)
class Device:
    """A single accelerator instance inside a cluster."""

    device_id: int
    cls: DeviceClass
    host: int

    @property
    def name(self) -> str:
        return f"{self.cls.name}#{self.device_id}"


@dataclasses.dataclass
class ClusterSpec:
    """An inventory of devices grouped by host.

    The paper's default testbed: one host with 4×A100, two hosts with 2×3090
    each, one host with 4×P100, on a 100 Gbps LAN.
    """

    devices: List[Device]

    @staticmethod
    def build(hosts: Sequence[Tuple[str, int]]) -> "ClusterSpec":
        """``hosts`` is a list of (device_class_name, count) per host."""
        devices: List[Device] = []
        did = 0
        for host_idx, (cls_name, count) in enumerate(hosts):
            cls = DEVICE_CLASSES[cls_name]
            for _ in range(count):
                devices.append(Device(did, cls, host_idx))
                did += 1
        return ClusterSpec(devices)

    @staticmethod
    def paper_testbed() -> "ClusterSpec":
        return ClusterSpec.build([("A100", 4), ("3090", 2), ("3090", 2), ("P100", 4)])

    # -- views -------------------------------------------------------------
    def by_class(self) -> Dict[str, List[Device]]:
        out: Dict[str, List[Device]] = {}
        for d in self.devices:
            out.setdefault(d.cls.name, []).append(d)
        return out

    def classes_by_power(self, reverse: bool = False) -> List[str]:
        """Device class names sorted low-end -> high-end by dense throughput."""
        names = sorted(self.by_class().keys(),
                       key=lambda n: DEVICE_CLASSES[n].dense_tflops,
                       reverse=reverse)
        return names

    def total_mem_gb(self) -> float:
        return sum(d.cls.mem_gb for d in self.devices)

    def same_host(self, a: Device, b: Device) -> bool:
        return a.host == b.host

    def link_gbps(self, a: Device, b: Device) -> float:
        """Point-to-point bandwidth between two devices (GB/s)."""
        if a.device_id == b.device_id:
            return float("inf")
        if self.same_host(a, b):
            return min(a.cls.intra_link_gbps, b.cls.intra_link_gbps)
        return min(a.cls.inter_link_gbps, b.cls.inter_link_gbps)

    def remove(self, device_ids: Sequence[int]) -> "ClusterSpec":
        gone = set(device_ids)
        return ClusterSpec([d for d in self.devices if d.device_id not in gone])

    def subsets_of_class_counts(self) -> List[Dict[str, int]]:
        """Enumerate per-class count combinations (for instance grouping)."""
        by_cls = self.by_class()
        names = sorted(by_cls)
        ranges = [range(len(by_cls[n]) + 1) for n in names]
        out = []
        for combo in itertools.product(*ranges):
            if sum(combo) == 0:
                continue
            out.append({n: c for n, c in zip(names, combo) if c > 0})
        return out

    def __len__(self) -> int:
        return len(self.devices)
