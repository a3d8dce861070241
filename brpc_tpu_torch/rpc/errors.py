"""RPC error codes — a copy of brpc_tpu/rpc/errors.py (brpc's errno.proto).

The numbers travel in RpcResponseMeta.error_code, so they must stay equal to
the reference's for the two packages to interoperate on one connection.
"""
from __future__ import annotations

import errno as _errno

# system-ish
EPERM = _errno.EPERM
EINVAL = _errno.EINVAL
ETIMEDOUT = _errno.ETIMEDOUT
ENOSERVICE = 1001  # service not found
ENOMETHOD = 1002  # method not found
EREQUEST = 1003  # bad request format
EAUTH = 1004  # authentication failed
ETOOMANYFAILS = 1005  # too many sub-channel failures (ParallelChannel)
EBACKUPREQUEST = 1007  # backup request triggered (internal)
ERPCTIMEDOUT = 1008  # RPC deadline exceeded
EFAILEDSOCKET = 1009  # the connection broke during the RPC
EHTTP = 1010  # non-2xx HTTP status
EOVERCROWDED = 1011  # too many buffered writes
ERTMPPUBLISHABLE = 1012
ERTMPCREATESTREAM = 1013
EEOF = 1014  # stream EOF
EUNUSED = 1015
ESSL = 1016
EPROTONOTSUP = 1017  # protocol not supported / mismatch
EREJECT = 1018  # request rejected (cluster recovering, errno.proto:43)
EOVERLOAD = 1019  # concurrency limit rejected the request
ELIMIT = 2004  # reached max_concurrency
ECLOSE = 2005  # connection closed by peer
EITP = 2006

ECANCELED = _errno.ECANCELED  # RPC cancelled by caller (StartCancel)

ENOBUF = 2401  # device buffer exhausted (TPU-native)
EDEVICE = 2402  # device transfer failed (TPU-native)

_DESCRIPTIONS = {
    ENOSERVICE: "service not found",
    ENOMETHOD: "method not found",
    EREQUEST: "bad request",
    EAUTH: "authentication failed",
    ETOOMANYFAILS: "too many sub-channel failures",
    EBACKUPREQUEST: "backup request",
    ERPCTIMEDOUT: "rpc timed out",
    EFAILEDSOCKET: "broken socket during rpc",
    EHTTP: "http error",
    EOVERCROWDED: "socket write buffer overcrowded",
    EEOF: "end of stream",
    ESSL: "ssl error",
    EPROTONOTSUP: "protocol mismatch",
    EOVERLOAD: "server overloaded",
    ELIMIT: "max concurrency reached",
    ECLOSE: "connection closed",
    ECANCELED: "rpc cancelled",
    ENOBUF: "device buffer exhausted",
    EDEVICE: "device transfer failed",
}


def berror(code: int) -> str:
    try:
        return _DESCRIPTIONS.get(code) or _errno.errorcode.get(code, f"error {code}")
    except Exception:
        return f"error {code}"
