"""Redis (RESP) messages and the server's command table.

Port of brpc_tpu/rpc/redis.py, byte-compatible with it: ``encode_command``
writes a command as a RESP array of bulk strings; ``RedisReply`` is the
RESP value (status, error, integer, string, array, nil) with its
encoding, and ``parse_reply`` reads one back (None until it is whole);
``RedisRequest`` batches commands and ``RedisResponse`` holds their
replies; ``RedisService`` lets a server speak redis, one handler per
command name (PING and COMMAND built in), and ``DictRedisService`` is an
in-memory SET/GET/DEL/EXISTS/INCR store. A bulk string is ``bytes``
whatever the read handed the parser.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple, Union

# -- RESP encoding ----------------------------------------------------------


def encode_command(args: Tuple) -> bytes:
    """One command as a RESP array of bulk strings."""
    out = [f"*{len(args)}\r\n".encode()]
    for a in args:
        if isinstance(a, bytes):
            b = a
        else:
            b = str(a).encode()
        out.append(f"${len(b)}\r\n".encode())
        out.append(b)
        out.append(b"\r\n")
    return b"".join(out)


class RedisReply:
    """RESP value: kind in {status,error,integer,string,array,nil}."""

    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value=None):
        self.kind = kind
        self.value = value

    # -- constructors used by server handlers
    @classmethod
    def status(cls, s: str) -> "RedisReply":
        return cls("status", s)

    @classmethod
    def error(cls, s: str) -> "RedisReply":
        return cls("error", s)

    @classmethod
    def integer(cls, v: int) -> "RedisReply":
        return cls("integer", int(v))

    @classmethod
    def string(cls, v: Union[str, bytes]) -> "RedisReply":
        return cls("string", v.encode() if isinstance(v, str) else v)

    @classmethod
    def nil(cls) -> "RedisReply":
        return cls("nil")

    @classmethod
    def array(cls, items: List["RedisReply"]) -> "RedisReply":
        return cls("array", items)

    def is_nil(self) -> bool:
        return self.kind == "nil"

    def is_error(self) -> bool:
        return self.kind == "error"

    def encode(self) -> bytes:
        if self.kind == "status":
            return f"+{self.value}\r\n".encode()
        if self.kind == "error":
            return f"-{self.value}\r\n".encode()
        if self.kind == "integer":
            return f":{self.value}\r\n".encode()
        if self.kind == "nil":
            return b"$-1\r\n"
        if self.kind == "string":
            return f"${len(self.value)}\r\n".encode() + self.value + b"\r\n"
        if self.kind == "array":
            out = [f"*{len(self.value)}\r\n".encode()]
            out.extend(item.encode() for item in self.value)
            return b"".join(out)
        raise ValueError(f"bad reply kind {self.kind}")

    def __repr__(self):
        return f"RedisReply({self.kind}, {self.value!r})"


def parse_reply(data: bytes, pos: int) -> Optional[Tuple[RedisReply, int]]:
    """Parse one RESP value at data[pos:]; None if incomplete."""
    nl = data.find(b"\r\n", pos)
    if nl < 0:
        return None
    line = data[pos:nl]
    if not line:
        return None
    t, rest = line[:1], line[1:]
    after = nl + 2
    if t == b"+":
        return RedisReply("status", rest.decode()), after
    if t == b"-":
        return RedisReply("error", rest.decode()), after
    if t == b":":
        return RedisReply("integer", int(rest)), after
    if t == b"$":
        n = int(rest)
        if n < 0:
            return RedisReply("nil"), after
        if len(data) < after + n + 2:
            return None
        value = bytes(data[after:after + n])
        return RedisReply("string", value), after + n + 2
    if t == b"*":
        n = int(rest)
        if n < 0:
            return RedisReply("nil"), after
        items = []
        cur = after
        for _ in range(n):
            sub = parse_reply(data, cur)
            if sub is None:
                return None
            item, cur = sub
            items.append(item)
        return RedisReply("array", items), cur
    raise ValueError(f"bad RESP type byte {t!r}")


# -- request/response (redis.h RedisRequest/RedisResponse) ------------------

class RedisRequest:
    def __init__(self):
        self._commands: List[Tuple] = []

    def add_command(self, *args) -> bool:
        """add_command("SET", "k", "v") or add_command("SET k v")."""
        if len(args) == 1 and isinstance(args[0], str) and " " in args[0]:
            args = tuple(args[0].split())
        if not args:
            return False
        self._commands.append(args)
        return True

    @property
    def command_count(self) -> int:
        return len(self._commands)

    def serialize(self) -> bytes:
        return b"".join(encode_command(c) for c in self._commands)


class RedisResponse:
    def __init__(self):
        self._replies: List[RedisReply] = []

    def add(self, reply: RedisReply):
        self._replies.append(reply)

    @property
    def reply_count(self) -> int:
        return len(self._replies)

    def reply(self, index: int) -> RedisReply:
        return self._replies[index]


# -- server side (redis.h RedisService / RedisCommandHandler) ---------------

CommandHandler = Callable[[List[bytes]], RedisReply]


class RedisService:
    """Server-side redis: register handlers per command name
    (brpc::RedisService::AddCommandHandler)."""

    def __init__(self):
        self._handlers: Dict[str, CommandHandler] = {}
        self._lock = threading.Lock()
        self.add_command_handler("ping", lambda args: RedisReply.status("PONG"))
        self.add_command_handler(
            "command", lambda args: RedisReply.array([]))

    def add_command_handler(self, name: str, handler: CommandHandler):
        with self._lock:
            self._handlers[name.lower()] = handler

    def dispatch(self, args: List[bytes]) -> RedisReply:
        if not args:
            return RedisReply.error("ERR empty command")
        name = args[0].decode("utf-8", "replace").lower()
        handler = self._handlers.get(name)
        if handler is None:
            return RedisReply.error(f"ERR unknown command '{name}'")
        try:
            return handler(args[1:])
        except Exception as e:
            return RedisReply.error(f"ERR handler raised: {e}")


class DictRedisService(RedisService):
    """A SET/GET/DEL/EXISTS/INCR in-memory impl — the fixture brpc's redis
    server test uses (and a usable micro-KV)."""

    def __init__(self):
        super().__init__()
        self._data: Dict[bytes, bytes] = {}
        self._data_lock = threading.Lock()
        self.add_command_handler("set", self._set)
        self.add_command_handler("get", self._get)
        self.add_command_handler("del", self._del)
        self.add_command_handler("exists", self._exists)
        self.add_command_handler("incr", self._incr)

    def _set(self, args):
        if len(args) != 2:
            return RedisReply.error("ERR wrong number of arguments for 'set'")
        with self._data_lock:
            self._data[args[0]] = args[1]
        return RedisReply.status("OK")

    def _get(self, args):
        if len(args) != 1:
            return RedisReply.error("ERR wrong number of arguments for 'get'")
        with self._data_lock:
            v = self._data.get(args[0])
        return RedisReply.nil() if v is None else RedisReply.string(v)

    def _del(self, args):
        n = 0
        with self._data_lock:
            for k in args:
                if self._data.pop(k, None) is not None:
                    n += 1
        return RedisReply.integer(n)

    def _exists(self, args):
        with self._data_lock:
            return RedisReply.integer(
                sum(1 for k in args if k in self._data))

    def _incr(self, args):
        if len(args) != 1:
            return RedisReply.error("ERR wrong number of arguments for 'incr'")
        with self._data_lock:
            try:
                v = int(self._data.get(args[0], b"0")) + 1
            except ValueError:
                return RedisReply.error(
                    "ERR value is not an integer or out of range")
            self._data[args[0]] = str(v).encode()
            return RedisReply.integer(v)
