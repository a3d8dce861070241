"""bvar — named counters: the Variable registry and the reducers the client
reads (``rpc_client_calls``, ``rpc_backup_requests``, ``rpc_retries``).
The window and sampler variables and the console come with the
reference-grade server."""
from brpc_tpu_torch.bvar.reducer import Adder, Maxer, Reducer  # noqa: F401
from brpc_tpu_torch.bvar.variable import Variable, find_exposed  # noqa: F401
