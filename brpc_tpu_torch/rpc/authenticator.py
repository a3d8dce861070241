"""Authenticator — the credential a client sends and a server checks.

Port of brpc_tpu/rpc/authenticator.py: the client's ``ChannelOptions.auth``
makes a credential for each request (tpu_std carries it in
``RpcRequestMeta.auth_data``, hulu in ``credential_data``); the server's
``ServerOptions.auth`` verifies it before the request is dispatched, and
a good credential's ``AuthContext`` is the handler's
``cntl.auth_context``. ``HmacAuthenticator`` is the shared-secret
policy: ``user:hexdigest``, the HMAC-SHA256 of the user under the
secret, the same string as the reference's.
"""
from __future__ import annotations

import hashlib
import hmac
from typing import Optional, Tuple


class AuthContext:
    """What a verified credential stands for."""

    __slots__ = ("user", "group", "roles", "is_service")

    def __init__(self, user: str = "", group: str = "", roles: str = "",
                 is_service: bool = False):
        self.user = user
        self.group = group
        self.roles = roles
        self.is_service = is_service


class Authenticator:
    def generate_credential(self, cntl) -> Optional[str]:
        """Client side: the credential to send; None fails the call."""
        raise NotImplementedError

    def verify_credential(self, auth_str: str,
                          remote_side) -> Tuple[bool, Optional[AuthContext]]:
        """Server side: (ok, context)."""
        raise NotImplementedError


class HmacAuthenticator(Authenticator):
    """A shared secret: the credential is ``user:hexdigest(user)``."""

    def __init__(self, secret: bytes, user: str = "default"):
        self._secret = secret
        self._user = user

    def _digest(self, user: str) -> str:
        return hmac.new(self._secret, user.encode(), hashlib.sha256).hexdigest()

    def generate_credential(self, cntl) -> Optional[str]:
        return f"{self._user}:{self._digest(self._user)}"

    def verify_credential(self, auth_str, remote_side):
        user, _, digest = (auth_str or "").partition(":")
        if not user or not hmac.compare_digest(digest, self._digest(user)):
            return False, None
        return True, AuthContext(user=user)
