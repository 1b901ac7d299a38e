from repro_torch.sim.des import SimResult, simulate
from repro_torch.sim.systems import HetisSystem, HexgenSystem, SplitwiseSystem
from repro_torch.sim.workloads import WORKLOADS, make_trace
