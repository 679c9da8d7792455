from repro_torch.runtime.fault import (  # noqa: F401
    ElasticPlan,
    HeartbeatTracker,
    LaneSupervisor,
    StragglerMonitor,
    plan_elastic_remesh,
)
