"""Chaos engine: production traffic simulator + multi-layer fault
injection.

The port's copy of `corrosion_tpu/chaos/`: `faults` holds the store-layer
injector and the process-global chaos census, `scenarios` composes the
network/store/process knobs into named scenarios driven by a
`ChaosEngine`, and `workload` runs the mixed read/write/subscribe/render
traffic the scenario matrix measures under (`traffic_sim.py` runs the
matrix).
"""

from corrosion_tpu_torch.chaos.faults import CENSUS, ChaosCensus, StoreFaults
from corrosion_tpu_torch.chaos.scenarios import (
    ChaosEngine,
    Injection,
    Scenario,
)

__all__ = [
    "CENSUS",
    "ChaosCensus",
    "ChaosEngine",
    "Injection",
    "Scenario",
    "StoreFaults",
]
