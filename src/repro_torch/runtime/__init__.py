"""repro_torch.runtime — multi-tenant streaming runtime over the CEP engine.

Port of ``repro.runtime``: chunked ingestion with an owned carry
(constant-memory unbounded streams), online Markov/utility model refresh
between chunks, tenant lanes in lockstep (on ``cuda_block`` one launch of
the block kernel's lane instance per W-event block, one CTA per lane),
per-chunk telemetry, and the resilience layer (bounded admission
front-end, degradation ladder, carry guard/recovery, fault injection)
plus durable crash recovery (versioned snapshots + a write-ahead event
log, ``persist``; the process-level chaos harness is ``supervisor``).
See DESIGN.md §7, §8, §12, §13.
"""
from repro_torch.runtime.chunker import (ChunkBuffer, concat_events,
                                         iter_chunks, num_events,
                                         slice_events)
from repro_torch.runtime.faults import (FAULT_KINDS, KILL_ENV, KILL_SITES,
                                        PROCESS_FAULTS, STATE_FAULTS,
                                        STREAM_FAULTS, FaultConfig,
                                        FaultInjector, KillSwitch,
                                        install_kill_from_env,
                                        install_kill_switch, kill_point)
from repro_torch.runtime.guard import (CARRY_CHECKS, MODEL_CHECKS,
                                       CarryGuard, GuardConfig,
                                       GuardViolation, carry_check_lanes,
                                       carry_check_vec, model_check_lanes,
                                       model_check_vec, trim_store,
                                       trim_store_lanes)
from repro_torch.runtime.ingest import (AdmitReport, IngestConfig,
                                        IngestFrontEnd, IngestQueue,
                                        neutral_like, take_rows)
from repro_torch.runtime.lanes import (broadcast_model, init_lane_carries,
                                       num_lanes, run_chunk_lanes,
                                       run_chunk_lanes_donated, stack,
                                       unstack_lane)
from repro_torch.runtime.persist import (CorruptSegmentError,
                                         CorruptSnapshotError,
                                         ManifestMismatchError,
                                         PersistConfig, Persistence,
                                         PersistError, SnapshotStore,
                                         WriteAheadLog, decode_tree,
                                         encode_tree)
from repro_torch.runtime.refresh import (RefreshConfig, RefreshState,
                                         prepare_model, refit_latency_model,
                                         refresh_model, table_width)
from repro_torch.runtime.service import (RUNG_INPUT_SHED, RUNG_NAMES,
                                         RUNG_NORMAL, RUNG_PM_TRIM,
                                         RUNG_QUARANTINE, DegradationLadder,
                                         LadderConfig, MultiTenantRuntime,
                                         RuntimeConfig, StreamRuntime)
from repro_torch.runtime.telemetry import (ChunkStats, RuntimeEvent,
                                           TelemetryLog, counter_snapshot,
                                           device_chunk_stats,
                                           summarize_chunk)

__all__ = [
    "ChunkBuffer", "concat_events", "iter_chunks", "num_events",
    "slice_events",
    "FAULT_KINDS", "KILL_ENV", "KILL_SITES", "PROCESS_FAULTS",
    "STATE_FAULTS", "STREAM_FAULTS", "FaultConfig", "FaultInjector",
    "KillSwitch", "install_kill_from_env", "install_kill_switch",
    "kill_point",
    "CorruptSegmentError", "CorruptSnapshotError", "ManifestMismatchError",
    "PersistConfig", "Persistence", "PersistError", "SnapshotStore",
    "WriteAheadLog", "decode_tree", "encode_tree",
    "CARRY_CHECKS", "MODEL_CHECKS", "CarryGuard", "GuardConfig",
    "GuardViolation", "carry_check_lanes", "carry_check_vec",
    "model_check_lanes", "model_check_vec", "trim_store",
    "trim_store_lanes",
    "AdmitReport", "IngestConfig", "IngestFrontEnd", "IngestQueue",
    "neutral_like", "take_rows",
    "broadcast_model", "init_lane_carries", "num_lanes",
    "run_chunk_lanes", "run_chunk_lanes_donated", "stack", "unstack_lane",
    "RefreshConfig", "RefreshState", "prepare_model", "refit_latency_model",
    "refresh_model", "table_width",
    "RUNG_INPUT_SHED", "RUNG_NAMES", "RUNG_NORMAL", "RUNG_PM_TRIM",
    "RUNG_QUARANTINE", "DegradationLadder", "LadderConfig",
    "MultiTenantRuntime", "RuntimeConfig", "StreamRuntime",
    "ChunkStats", "RuntimeEvent", "TelemetryLog", "counter_snapshot",
    "device_chunk_stats", "summarize_chunk",
]
