"""Status — an error code and its text, as a value.

Port of brpc_tpu/butil/status.py (butil::Status): a cheap (code, text)
pair whose code 0 means OK, returned by fallible calls instead of an
exception on hot paths, with the framework's error codes.
"""
from __future__ import annotations


class Status:
    __slots__ = ("code", "text")

    OK_CODE = 0

    def __init__(self, code: int = 0, text: str = ""):
        self.code = code
        self.text = text

    @classmethod
    def ok(cls) -> "Status":
        return cls(0, "")

    @classmethod
    def error(cls, code: int, text: str) -> "Status":
        if code == 0:
            raise ValueError("error status must have nonzero code")
        return cls(code, text)

    def is_ok(self) -> bool:
        return self.code == 0

    def __bool__(self) -> bool:
        return self.is_ok()

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Status)
            and self.code == other.code
            and self.text == other.text
        )

    def __repr__(self) -> str:
        if self.is_ok():
            return "Status.OK"
        return f"Status({self.code}, {self.text!r})"


# The framework's error codes, as brpc's errno extensions (errno.proto)
# number them.
ENOSERVICE = 1001  # service not found
ENOMETHOD = 1002  # method not found
EREQUEST = 1003  # bad request
ERPCAUTH = 1004  # authentication failed
ETOOMANYFAILS = 1005  # too many sub-channel failures (ParallelChannel)
EBACKUPREQUEST = 1007  # backup request fired
ERPCTIMEDOUT = 1008  # RPC deadline exceeded
EFAILEDSOCKET = 1009  # connection broken during RPC
EHTTP = 1010  # HTTP-level error
EOVERCROWDED = 1011  # too many buffered writes
ERTMPPUBLISHABLE = 1012
ERTMPCREATESTREAM = 1013
EEOF = 1014  # stream EOF
EUNUSED = 1015
ESSL = 1016
EINTERNAL = 2001  # framework internal error
ERESPONSE = 2002  # bad response
ELOGOFF = 2003  # server is logging off (graceful stop)
ELIMIT = 2004  # concurrency limit reached
ECLOSE = 2005  # close socket initiatively
EITP = 2006
ECANCELED = 2007  # RPC canceled by caller
