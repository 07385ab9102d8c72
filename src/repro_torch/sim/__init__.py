"""Device-resident quasi-static simulation loops: the time march (torch
twin of ``repro.sim``).

Material evolution marched through fused ``assembly -> recompute ->
warm-started solve`` steps on the device, with adaptive re-coarsening at
staleness-tripped segment boundaries.  See ``repro_torch.sim.driver``.
"""
from repro_torch.sim.driver import (
    MarchCarry,
    MarchConfig,
    MarchResult,
    SegmentInfo,
    StepRecord,
    init_carry,
    make_scan_march,
    make_segment,
    make_step,
    make_step_fn,
    march,
)
from repro_torch.sim.scenarios import SofteningScenario, ThermalScenario
from repro_torch.sim.staleness import (
    StalenessConfig,
    StalenessState,
    staleness_init,
    staleness_update,
)

__all__ = [
    "MarchCarry", "MarchConfig", "MarchResult", "SegmentInfo",
    "StepRecord", "init_carry", "make_scan_march", "make_segment",
    "make_step", "make_step_fn", "march",
    "SofteningScenario", "ThermalScenario",
    "StalenessConfig", "StalenessState", "staleness_init",
    "staleness_update",
]
