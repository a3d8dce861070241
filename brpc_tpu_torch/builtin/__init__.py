"""builtin — the services behind a server's debug console, as in
brpc_tpu/builtin: the console's pages (``console.py``), the profilers
behind ``/hotspots`` (``hotspots.py``, ``profilers.py``: the host's CPU,
heap, growth and lock contention, and the card trace ``cuda_trace``).
A server registers them at start unless
``ServerOptions.has_builtin_services`` is off; the HTTP protocol serves
them on the RPC port.
"""
from __future__ import annotations


def register_builtin_services(server) -> None:
    """Attach the console's handlers to ``server``."""
    from brpc_tpu_torch.builtin.console import attach_console

    attach_console(server)
