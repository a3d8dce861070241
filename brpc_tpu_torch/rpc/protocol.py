"""Parse results and the parsed-message base shared by the two framings
this port speaks on one connection (``TDEV`` handshake, ``TRPC`` frames).

The parts of brpc_tpu/rpc/protocol.py the tensor lane reads; the port has
no protocol registry: its server tries the two parsers in turn.
"""
from __future__ import annotations


class ParseResult:
    OK = 0
    NOT_ENOUGH_DATA = 1
    TRY_OTHERS = 2
    ERROR = 3

    __slots__ = ("status", "message")

    def __init__(self, status: int, message=None):
        self.status = status
        self.message = message

    @classmethod
    def ok(cls, message) -> "ParseResult":
        return cls(cls.OK, message)

    @classmethod
    def not_enough(cls) -> "ParseResult":
        return cls(cls.NOT_ENOUGH_DATA)

    @classmethod
    def try_others(cls) -> "ParseResult":
        return cls(cls.TRY_OTHERS)

    @classmethod
    def error_(cls) -> "ParseResult":
        return cls(cls.ERROR)


class InputMessageBase:
    """A parsed message; the reader fills ``socket`` and ``arg`` (the
    server) before processing it."""

    __slots__ = ("socket", "arg")

    def __init__(self):
        self.socket = None
        self.arg = None
