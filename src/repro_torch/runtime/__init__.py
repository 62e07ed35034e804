"""repro_torch.runtime — multi-tenant streaming runtime over the CEP engine.

Port of ``repro.runtime``'s core: chunked ingestion with an owned carry
(constant-memory unbounded streams), online Markov/utility model refresh
between chunks, tenant lanes in lockstep (on ``cuda_block`` one launch of
the block kernel's lane instance per W-event block, one CTA per lane),
and per-chunk telemetry.  See DESIGN.md §7, §8.  The resilience layer
and durable persistence (ingest, faults, guard, persist, supervisor, the
degradation ladder) come with a later slice (ROADMAP.md queue 1, item
3b).
"""
from repro_torch.runtime.chunker import (ChunkBuffer, concat_events,
                                         iter_chunks, num_events,
                                         slice_events)
from repro_torch.runtime.lanes import (broadcast_model, init_lane_carries,
                                       num_lanes, run_chunk_lanes,
                                       run_chunk_lanes_donated, stack,
                                       unstack_lane)
from repro_torch.runtime.refresh import (RefreshConfig, RefreshState,
                                         prepare_model, refit_latency_model,
                                         refresh_model, table_width)
from repro_torch.runtime.service import (MultiTenantRuntime, RuntimeConfig,
                                         StreamRuntime)
from repro_torch.runtime.telemetry import (ChunkStats, RuntimeEvent,
                                           TelemetryLog, counter_snapshot,
                                           device_chunk_stats,
                                           summarize_chunk)

__all__ = [
    "ChunkBuffer", "concat_events", "iter_chunks", "num_events",
    "slice_events",
    "broadcast_model", "init_lane_carries", "num_lanes",
    "run_chunk_lanes", "run_chunk_lanes_donated", "stack", "unstack_lane",
    "RefreshConfig", "RefreshState", "prepare_model", "refit_latency_model",
    "refresh_model", "table_width",
    "MultiTenantRuntime", "RuntimeConfig", "StreamRuntime",
    "ChunkStats", "RuntimeEvent", "TelemetryLog", "counter_snapshot",
    "device_chunk_stats", "summarize_chunk",
]
