"""builtin — the services behind a server's debug console, as in
brpc_tpu/builtin. So far the card trace of the profilers
(``profilers.cuda_trace``); the console, the HTTP routes and the host
profilers come with the HTTP protocol.
"""
