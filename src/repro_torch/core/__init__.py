"""Core: the paper's contributions — sync strategies, elastic scheduler,
control plane, WAN simulator, cost model.  The reference's re-exports
(``repro/core/__init__.py``), each from the port's own module."""
from repro_torch.core.sync import SyncConfig, SyncState, CODEC_TIERS, \
    BUCKET_CLASSES, BucketOverride, BucketSpec, BucketLayout, \
    bucket_layout, bucket_weights_of, \
    init_sync_state, on_step_gradients, apply_sync, is_sync_step, \
    traffic_per_step_mb, grow_pods, shrink_pods, resize_sync_state, \
    retune_sync_state  # noqa: F401
from repro_torch.core.scheduler import CloudResources, ResourcePlan, \
    DeviceType, CATALOG, load_power, optimal_matching, predict_times, \
    waiting_fraction, plan_batch_split, PlanDiff, diff_plans, \
    incremental_matching  # noqa: F401
from repro_torch.core.wan import SimCloud, SimEvent, WANConfig, SimResult, \
    BandwidthTrace, simulate, compare_strategies  # noqa: F401
from repro_torch.core.cost import CostReport, cost_report, \
    tier_payload_table, bucket_payload_table, \
    adaptive_traffic_mb  # noqa: F401
from repro_torch.core.autotune import AdaptiveSyncController, BucketStats, \
    BucketedSyncController, BucketPlanUpdate, SyncPlanUpdate, WanProbe, \
    WanProbeEstimator, bucket_stats_from_sync_state, \
    build_ladder  # noqa: F401
from repro_torch.core.control_plane import FunctionRegistry, AddressTable, \
    Workflow, WorkflowEngine, TrainingRequest, TrainingPlan, \
    SchedulerFunction, CommunicatorFunction, build_training_plan, \
    training_workflow, reschedule, CloudEvent, EventBus, \
    ElasticityController, ReconfigPlan, adapt_interval  # noqa: F401
