"""Task runtime: result futures + locality-aware placement over the
unified ifunc transport.

    TaskRuntime      submit() -> Future; reply demux; run_local
    Future           done/result/exception/timeout, progress-driving wait
    DataDirectory    shard-id -> owner/replicas/hotness
    PlacementEngine  migrate-code-to-data vs fetch-data-to-host vs
                     run-local, priced with live dispatcher congestion;
                     work-stealing ownership rebalance
    wire             tagged reply-payload codec (RAW | JSON | NPY | ERR)
    graph            the CSR shard codec and the source-side relax

``chip_smoke.graph_workload`` is the port's ``examples/graph_analysis.py``:
the end-to-end workload over all of these.
"""

from repro_torch.tasks.future import Future, TaskState, TaskTimeout, wait_all
from repro_torch.tasks.placement import (DataDirectory, Decision, LOCAL_SITE,
                                         Placement, PlacementEngine, Shard)
from repro_torch.tasks.runtime import TaskRuntime
from repro_torch.tasks.wire import RemoteExecutionError, WireError

__all__ = ["DataDirectory", "Decision", "Future", "LOCAL_SITE", "Placement",
           "PlacementEngine", "RemoteExecutionError", "Shard", "TaskRuntime",
           "TaskState", "TaskTimeout", "WireError", "wait_all"]
