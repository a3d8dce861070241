"""bvar — named metrics: the Variable registry, the reducers (Adder,
Maxer, IntRecorder), the windows and the sampler thread behind
them, percentiles, the LatencyRecorder of every server method, the
process variables a server exposes, labelled metrics (MultiDimension),
the sampling Collector (``bvar.collector``), the native runtime's stat
cells (``register_native_bvars``), and the bridge that exposes every
flag as a variable. The console (brpc_tpu_torch/builtin/console.py) shows
them on ``/vars`` and ``/brpc_metrics``."""
from brpc_tpu_torch.bvar.default_variables import expose_default_variables  # noqa: F401
from brpc_tpu_torch.bvar.latency_recorder import LatencyRecorder  # noqa: F401
from brpc_tpu_torch.bvar.multi_dimension import MultiDimension  # noqa: F401
from brpc_tpu_torch.bvar.native_vars import register_native_bvars  # noqa: F401
from brpc_tpu_torch.bvar.percentile import Percentile  # noqa: F401
from brpc_tpu_torch.bvar.reducer import Adder, IntRecorder, Maxer, Reducer  # noqa: F401
from brpc_tpu_torch.bvar.sampler import force_tick_for_tests  # noqa: F401
from brpc_tpu_torch.bvar.variable import (  # noqa: F401
    PassiveStatus,
    Variable,
    count_exposed,
    dump_exposed,
    dump_prometheus,
    find_exposed,
    list_exposed,
)
from brpc_tpu_torch.bvar.window import PerSecond, Window  # noqa: F401


def expose_flags_as_bvars():
    """Every defined flag becomes a PassiveStatus named flag_<name>."""
    from brpc_tpu_torch.butil import flags as _flags

    for name, f in _flags.all_flags().items():
        bvar_name = f"flag_{name}"
        if find_exposed(bvar_name) is None:
            PassiveStatus(lambda f=f: f.value, bvar_name)
