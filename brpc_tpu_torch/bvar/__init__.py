"""bvar — named metrics: the Variable registry, the reducers (Adder,
Maxer, IntRecorder), the windows and the sampler thread behind
them, percentiles, the LatencyRecorder of every server method, and the
process variables a server exposes. The console that shows them comes
with the HTTP protocol."""
from brpc_tpu_torch.bvar.default_variables import expose_default_variables  # noqa: F401
from brpc_tpu_torch.bvar.latency_recorder import LatencyRecorder  # noqa: F401
from brpc_tpu_torch.bvar.percentile import Percentile  # noqa: F401
from brpc_tpu_torch.bvar.reducer import Adder, IntRecorder, Maxer, Reducer  # noqa: F401
from brpc_tpu_torch.bvar.sampler import force_tick_for_tests  # noqa: F401
from brpc_tpu_torch.bvar.variable import (  # noqa: F401
    PassiveStatus,
    Variable,
    dump_exposed,
    find_exposed,
)
from brpc_tpu_torch.bvar.window import PerSecond, Window  # noqa: F401
