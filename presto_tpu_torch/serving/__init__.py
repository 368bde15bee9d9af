"""Multi-tenant serving plane.

The counterpart of ``presto_tpu/serving/``: the layer-3 analogue of the
reference's dispatcher and resource-group subsystem (reference
presto-main/.../dispatcher/DispatchManager.java and
execution/resourcegroups/InternalResourceGroup.java), shaped for one
shared device and steady repeated traffic:

- :mod:`presto_tpu_torch.serving.plancache`: the parse cache and the
  compiled-plan cache keyed by a statement fingerprint, so a repeated
  or EXECUTE'd statement skips parse, plan and optimize;
- :mod:`presto_tpu_torch.serving.template`: parameter-generic plan
  templates, one plan for a fleet of bindings;
- :mod:`presto_tpu_torch.serving.resultcache`: versioned results with
  incremental maintenance over appended files;
- :mod:`presto_tpu_torch.serving.groups`: the per-query serving context
  that bridges an admitted resource group into execution: memory
  reservations charged to the group (kill-or-queue on limits) and a
  weighted device-scheduler share (``exec/taskexec``).

``server/resource_groups.py`` stays the admission-control front.
"""
from .groups import QueryServingContext, group_snapshot  # noqa: F401
from .plancache import PLANS, PlanCache, cached_plan  # noqa: F401
