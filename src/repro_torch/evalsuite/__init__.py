"""`repro_torch.evalsuite` — the §5 reproduction & regression harness.

The reference's ``repro.evalsuite``, on the port.  The paper's empirical
claim is two-dimensional: Big-means must match or beat the §5 baselines
on *solution quality* (relative clustering error ε = (f − f*)/f* against
a best-known objective f*) while spending less time under an equal data
budget.  This package makes that claim a gated, versioned artifact:

* :mod:`repro_torch.evalsuite.datasets` — the dataset registry: GMM
  surrogates at paper-like shapes, generated on the CPU generator into
  on-disk memmaps, and the port's own best-known ``f_star`` per dataset.
* :mod:`repro_torch.evalsuite.metrics` — ε, success rate over seeds, and
  run-level time-to-target curves.
* :mod:`repro_torch.evalsuite.schema` — the versioned JSON schema
  (``repro.bench/1``, the reference's) every artifact is validated
  against before it is written.
* :mod:`repro_torch.evalsuite.suite` — the suite runner: Big-means
  strategies × precision × scheduler plus the §5 baselines, swept over
  the registry under an equal chunk budget through
  ``repro_torch.api.fit``, on the card unless ``device="cpu"``.
* :mod:`repro_torch.evalsuite.hostcell` — the two-process host-mesh cell.
* :mod:`repro_torch.evalsuite.gate` — the regression gate: diff a fresh
  suite document against a baseline document with per-metric
  tolerances; non-zero exit on quality or runtime regression.

::

    from repro_torch.evalsuite import suite
    doc = suite.run_suite("quick")                  # on the card
    doc = suite.run_suite("quick", device="cpu")    # plain path, CPU
    suite.write_outputs(doc, "BENCH_suite.json")

    PYTHONPATH=src python -m repro_torch.evalsuite.gate \\
        --baseline base_suite.json --fresh BENCH_suite.json
"""
from repro_torch.evalsuite.datasets import (
    DatasetSpec, get_dataset, list_datasets,
)
from repro_torch.evalsuite.metrics import (
    aggregate_cell,
    relative_error,
    success_rate,
    time_to_target_curve,
)
from repro_torch.evalsuite.schema import SCHEMA_VERSION, check, validate

__all__ = [
    "DatasetSpec",
    "SCHEMA_VERSION",
    "aggregate_cell",
    "check",
    "get_dataset",
    "list_datasets",
    "relative_error",
    "success_rate",
    "time_to_target_curve",
    "validate",
]
