"""Task runtime: result futures over the transport's reply path.

    TaskRuntime      submit() -> Future; reply demux; run_local
    Future           done/result/exception/timeout, progress-driving wait
    wire             tagged reply-payload codec (RAW | JSON | NPY | ERR)

Placement (``DataDirectory``, ``PlacementEngine``) and the graph workload
come with ROADMAP.md Queue 1 item 4.
"""

from repro_torch.tasks.future import Future, TaskState, TaskTimeout, wait_all
from repro_torch.tasks.runtime import TaskRuntime
from repro_torch.tasks.wire import RemoteExecutionError, WireError

__all__ = ["Future", "RemoteExecutionError", "TaskRuntime", "TaskState",
           "TaskTimeout", "WireError", "wait_all"]
