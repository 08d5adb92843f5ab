"""``combblas_tpu_torch.tuner`` — measured-cost tuner with persisted
plans, counterpart of ``combblas_tpu/tuner``.

* :mod:`~combblas_tpu_torch.tuner.config` — the ONE parser of the
  ``COMBBLAS_*`` knobs and the documented resolution precedence:
  **arg > store > env > probe > heuristic**.
* :mod:`~combblas_tpu_torch.tuner.store` — the schema-versioned JSONL
  plan store (``plans.jsonl`` in ``build/.plan_store`` by default, the
  sibling of the kernel build cache): plans keyed by (op, shape bucket,
  density band, semiring, backend, grid / grid3, platform) holding the
  measured tier / window / schedule / merge choice.
* :mod:`~combblas_tpu_torch.tuner.resolve` — ``resolve_tier`` and
  ``resolve_merge``, the shared walks of the chain.
* :mod:`~combblas_tpu_torch.tuner.probe` — the opt-in micro-probe pass
  (``COMBBLAS_TUNER_PROBE=1``): on a store miss, time the admissible
  rungs and write the winner back.

``parallel.spgemm.spgemm_auto``, ``parallel.mesh3d.spgemm3d`` and
``parallel.spmm.resolve_spmm_backend`` consult the store.  The probe
module is imported lazily (it pulls in the tiers); config and store are
dependency-light.
"""

from . import config  # noqa: F401
from .resolve import resolve_tier  # noqa: F401
from .store import (  # noqa: F401
    PlanKey,
    PlanRecord,
    PlanStore,
    SCHEMA,
    density_band,
    get_store,
    plan_key_from_counts,
    serve_plan_key,
    shape_bucket,
    spgemm3d_plan_key,
    spgemm_plan_key,
    spmm_plan_key,
)

__all__ = [
    "config",
    "resolve_tier",
    "PlanKey",
    "PlanRecord",
    "PlanStore",
    "SCHEMA",
    "density_band",
    "get_store",
    "plan_key_from_counts",
    "serve_plan_key",
    "shape_bucket",
    "spgemm3d_plan_key",
    "spgemm_plan_key",
    "spmm_plan_key",
]
