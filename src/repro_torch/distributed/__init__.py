"""Elasticity for the port: membership changes re-plan sigma*
(``fault_tolerance``).  Sharding waits for a later slice."""

from repro_torch.distributed.fault_tolerance import (ElasticController,
                                                     ElasticEvent)
