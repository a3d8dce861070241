"""trackme — version ping (phone-home), off by default.

Port of brpc_tpu/rpc/trackme.py (brpc/details/trackme.cpp): when the
``trackme_server`` flag is set, the process reports its version
(``brpc_tpu_torch.__version__``) to that endpoint every
``trackme_interval_s`` seconds, on the bthread timer, and logs any notice
in the reply. ``brpc_tpu_torch.tools.trackme_server`` is the receiving
end. Nothing calls ``start_trackme`` on its own.
"""
from __future__ import annotations

import json
import threading

from brpc_tpu_torch.butil import flags

flags.define_string("trackme_server", "", "endpoint to report version to "
                    "(empty = disabled)")
flags.define_int("trackme_interval_s", 300, "seconds between pings")

_started = False
_lock = threading.Lock()


def _ping_once() -> bool:
    """POST the version to the trackme server; True on a 200."""
    import http.client

    import brpc_tpu_torch

    target = flags.get_flag("trackme_server")
    if not target:
        return False
    host, _, port = target.partition(":")
    try:
        conn = http.client.HTTPConnection(host, int(port or 80), timeout=3)
        conn.request("POST", "/trackme",
                     body=json.dumps({"version": brpc_tpu_torch.__version__}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        if resp.status == 200 and body:
            notice = json.loads(body).get("notice")
            if notice:
                import logging

                logging.getLogger(__name__).warning("trackme notice: %s",
                                                    notice)
        return resp.status == 200
    except (OSError, ValueError):
        return False


def start_trackme():
    """Idempotent; no-op unless the trackme_server flag is set."""
    global _started
    if not flags.get_flag("trackme_server"):
        return
    with _lock:
        if _started:
            return
        _started = True
    from brpc_tpu_torch.bthread import timer_add

    def tick():
        _ping_once()
        timer_add(flags.get_flag("trackme_interval_s"), tick)

    timer_add(0.0, tick)
