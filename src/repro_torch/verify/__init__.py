"""repro_torch.verify — paper-grid differential conformance & regression
subsystem over the port (the port's copy of ``repro.verify``).

The paper's evaluation is an experiment grid — "different OHHC dimensions,
different integer array types and different array sizes" — and this package
turns that grid into an executable, CI-enforced contract (DESIGN.md §7):

* :mod:`repro_torch.verify.grid`          — parameterized scenario axes + pruning
* :mod:`repro_torch.verify.differential`  — every scenario vs the ``np.sort``
  oracle, plus cross-path agreement checks
* :mod:`repro_torch.verify.properties`    — metamorphic checks and fault-scenario
  stress via ``repro_torch.net.faults`` degraded schedules
* :mod:`repro_torch.verify.baseline`      — per-scenario JSON baselines with
  drift detection (a plan-policy change must be an explicit baseline
  update, never a silent flip)

CLI entry point: ``python -m repro_torch.verify --smoke`` (on the card;
``--device cpu`` runs the kernels' plain versions), see ``__main__.py``.
"""

from repro_torch.verify.grid import (
    DIMS,
    DTYPES,
    SIZE_BUCKETS,
    WORKLOAD_OPS,
    FaultCell,
    OpScenario,
    Scenario,
    fault_grid,
    full_grid,
    op_prune_reason,
    op_smoke_grid,
    op_tier1_grid,
    prune_reason,
    smoke_grid,
    tier1_grid,
)
from repro_torch.verify.differential import (
    ScenarioResult,
    cross_check,
    run_fault_grid,
    run_fault_scenario,
    run_grid,
    run_op_grid,
    run_op_scenario,
    run_scenario,
)
from repro_torch.verify.properties import (
    fault_replay,
    metamorphic_checks,
    pairs_pairing_check,
)
from repro_torch.verify.baseline import (
    DriftReport,
    build_baseline,
    diff_baselines,
    load_baseline,
    save_baseline,
)

__all__ = [
    "DIMS",
    "DTYPES",
    "SIZE_BUCKETS",
    "WORKLOAD_OPS",
    "FaultCell",
    "OpScenario",
    "Scenario",
    "fault_grid",
    "full_grid",
    "op_prune_reason",
    "op_smoke_grid",
    "op_tier1_grid",
    "prune_reason",
    "smoke_grid",
    "tier1_grid",
    "ScenarioResult",
    "cross_check",
    "run_fault_grid",
    "run_fault_scenario",
    "run_grid",
    "run_op_grid",
    "run_op_scenario",
    "run_scenario",
    "fault_replay",
    "metamorphic_checks",
    "pairs_pairing_check",
    "DriftReport",
    "build_baseline",
    "diff_baselines",
    "load_baseline",
    "save_baseline",
]
