"""Chaos engine: store-layer fault injection and the process-global
chaos census.

The port's copy of the ported part of `corrosion_tpu/chaos/`: `faults`
holds the store-layer injector and the census `/v1/status` serves. The
scenario engine (`scenarios.py`) and the traffic mix (`workload.py`)
come with ROADMAP §1 item 9.6.
"""

from corrosion_tpu_torch.chaos.faults import CENSUS, ChaosCensus, StoreFaults

__all__ = [
    "CENSUS",
    "ChaosCensus",
    "StoreFaults",
]
