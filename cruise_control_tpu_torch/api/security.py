"""Pluggable security providers.

Counterpart of ``cruise_control_tpu/api/security.py``.

Parity with ``servlet/security/`` (SecurityProvider SPI; HTTP Basic in
server.py): JWT bearer-token auth (security/jwt/JwtSecurityProvider +
JwtAuthenticator), trusted-proxy auth (security/trustedproxy/
TrustedProxySecurityProvider: an authenticated gateway forwards the end
user in a ``doAs`` parameter), and SPNEGO/Kerberos over HTTP Negotiate
(security/spnego/SpnegoSecurityProvider: challenge flow, principal
short-name mapping, user-store roles; the GSS-API accept step is pluggable
— python-gssapi when available, any Kerberos stack otherwise — exactly the
step the reference delegates to Jetty's ConfigurableSpnegoLoginService).

All stdlib: HS256 JWTs via hmac/hashlib/base64.  ``load_credentials`` reads
the realm file of ``webserver.auth.credentials.file`` (the port's copy of
the JAX package's ``app._load_credentials``, ``app.py:514``).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Dict, Iterable, Optional, Tuple

from cruise_control_tpu_torch.api.server import (ROLE_ADMIN, ROLE_USER, ROLE_VIEWER,
                                           BasicSecurityProvider,
                                           SecurityProvider)

_ROLES = {ROLE_VIEWER, ROLE_USER, ROLE_ADMIN}


def load_credentials(path: str) -> Dict[str, Tuple[str, str]]:
    """Jetty-style realm file: ``user: password, ROLE`` per line (blank and
    ``#`` lines skipped; the role defaults to VIEWER)."""
    creds: Dict[str, Tuple[str, str]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            user, _, rest = line.partition(":")
            password, _, role = rest.strip().partition(",")
            creds[user.strip()] = (password.strip(), role.strip() or "VIEWER")
    return creds


def _b64url_decode(part: str) -> bytes:
    return base64.urlsafe_b64decode(part + "=" * (-len(part) % 4))


def _b64url_encode(raw: bytes) -> str:
    return base64.urlsafe_b64encode(raw).decode().rstrip("=")


def encode_jwt(claims: Dict[str, object], secret: bytes) -> str:
    """Mint an HS256 JWT (test/ops helper — the reference validates tokens
    minted by an external issuer)."""
    header = _b64url_encode(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    body = _b64url_encode(json.dumps(claims).encode())
    signing_input = f"{header}.{body}".encode()
    sig = _b64url_encode(hmac.new(secret, signing_input, hashlib.sha256).digest())
    return f"{header}.{body}.{sig}"


class JwtSecurityProvider(SecurityProvider):
    """Validates ``Authorization: Bearer <jwt>`` (HS256) and maps the token's
    role claim onto the endpoint role model (security/jwt/)."""

    def __init__(self, secret: bytes, roles_claim: str = "roles",
                 issuer: Optional[str] = None,
                 default_role: Optional[str] = None):
        self._secret = secret
        self._roles_claim = roles_claim
        self._issuer = issuer
        self._default_role = default_role

    def authenticate(self, headers) -> Optional[str]:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Bearer "):
            return None
        token = auth[7:].strip()
        try:
            header_part, body_part, sig_part = token.split(".")
            header = json.loads(_b64url_decode(header_part))
            if header.get("alg") != "HS256":
                return None  # alg confusion (e.g. "none") is rejected
            signing_input = f"{header_part}.{body_part}".encode()
            expected = hmac.new(self._secret, signing_input,
                                hashlib.sha256).digest()
            if not hmac.compare_digest(expected, _b64url_decode(sig_part)):
                return None
            claims = json.loads(_b64url_decode(body_part))
            if not isinstance(claims, dict):
                return None
            exp = claims.get("exp")
            if exp is not None and time.time() > float(exp):
                return None
            if self._issuer is not None and claims.get("iss") != self._issuer:
                return None
            roles = claims.get(self._roles_claim, [])
            if isinstance(roles, str):
                roles = [roles]
            granted = [r.upper() for r in roles
                       if isinstance(r, str) and r.upper() in _ROLES]
        except (ValueError, KeyError, TypeError, AttributeError):
            # Malformed tokens (non-dict header/claims, non-numeric exp,
            # non-string roles, …) are an authentication failure (401),
            # never a 500.
            return None
        if not granted:
            return self._default_role
        # Highest granted role wins.
        for role in (ROLE_ADMIN, ROLE_USER, ROLE_VIEWER):
            if role in granted:
                return role
        return None


class KerberosName:
    """Kerberos principal name parsing (the subset of
    org.apache.kafka.common.security.kerberos.KerberosName the SPNEGO
    provider needs): ``service/host@REALM``, ``user@REALM``, or a bare
    short name; ``short_name`` is the first component — the default
    auth-to-local rule the reference applies to map principals onto the
    user store (SpnegoUserStoreAuthorizationService.java)."""

    def __init__(self, principal: str):
        self.principal = principal
        rest, _, self.realm = principal.partition("@")
        self.service_name, sep, self.host_name = rest.partition("/")
        if not sep:
            self.host_name = ""
        self.short_name = self.service_name

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"KerberosName({self.principal!r})"


class SpnegoSecurityProvider(SecurityProvider):
    """SPNEGO / Kerberos over HTTP Negotiate (RFC 4559), the analogue of
    ``servlet/security/spnego/SpnegoSecurityProvider.java``.

    The provider owns the HTTP mechanics — the ``Negotiate`` challenge on
    401, token extraction, principal → short-name mapping, and the
    user-store role lookup (the same Jetty-realm file the Basic provider
    reads; SpnegoUserStoreAuthorizationService semantics: principals not in
    the store are rejected).  The GSS-API *accept* step itself is pluggable
    (``gss_acceptor: bytes -> principal | None``): in production wrap your
    Kerberos stack (e.g. python-gssapi with the service keytab named by
    ``spnego.keytab.file`` / ``spnego.principal``); the reference equally
    delegates this step to Jetty's ConfigurableSpnegoLoginService."""

    def __init__(self, gss_acceptor=None,
                 user_roles: Optional[Dict[str, str]] = None,
                 keytab_path: str = "", principal: str = ""):
        self._acceptor = gss_acceptor
        self._user_roles = dict(user_roles or {})
        self.keytab_path = keytab_path
        self.principal = KerberosName(principal) if principal else None

    def configure(self, config: Dict[str, object]) -> None:
        from cruise_control_tpu_torch.config import constants as C
        self.keytab_path = str(config.get(C.SPNEGO_KEYTAB_FILE_CONFIG, "") or "")
        principal = str(config.get(C.SPNEGO_PRINCIPAL_CONFIG, "") or "")
        self.principal = KerberosName(principal) if principal else None
        path = config.get(C.WEBSERVER_AUTH_CREDENTIALS_FILE_CONFIG)
        if path:
            self._user_roles = {user: role for user, (_, role)
                                in load_credentials(str(path)).items()}
        if self._acceptor is None:
            try:  # pragma: no cover - optional dependency
                self._acceptor = _gssapi_acceptor(self.keytab_path,
                                                  self.principal)
            except ImportError as e:
                raise RuntimeError(
                    "SpnegoSecurityProvider needs a GSS-API acceptor: "
                    "install python-gssapi or construct the provider with "
                    f"gss_acceptor=... ({e})")

    def challenge_headers(self) -> Dict[str, str]:
        return {"WWW-Authenticate": "Negotiate"}

    def authenticate(self, headers) -> Optional[str]:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Negotiate "):
            return None
        try:
            token = base64.b64decode(auth[len("Negotiate "):].strip())
        except Exception:  # noqa: BLE001 — malformed token is a clean 401
            return None
        if self._acceptor is None:
            return None
        principal = self._acceptor(token)
        if not principal:
            return None
        short = KerberosName(principal).short_name
        role = self._user_roles.get(short)
        return role.upper() if role and role.upper() in _ROLES else None


def _gssapi_acceptor(keytab_path: str, principal: Optional[KerberosName]):
    """Build a real GSS-API acceptor from python-gssapi (raises ImportError
    when the binding is absent — the stdlib cannot validate Kerberos
    tickets)."""
    import gssapi  # noqa: F401 — optional, not in the base image

    store = {"keytab": keytab_path} if keytab_path else None
    name = None
    if principal is not None:
        name = gssapi.Name(principal.principal,
                           gssapi.NameType.kerberos_principal)
    creds = gssapi.Credentials(usage="accept", name=name, store=store)

    def accept(token: bytes) -> Optional[str]:
        ctx = gssapi.SecurityContext(creds=creds, usage="accept")
        ctx.step(token)
        return str(ctx.initiator_name) if ctx.complete else None

    return accept


class TrustedProxySecurityProvider(SecurityProvider):
    """An authenticated gateway makes requests on behalf of end users
    (security/trustedproxy/): the proxy itself authenticates (HTTP Basic
    here; SPNEGO in the reference) and names the end user in a
    ``X-Cruise-Control-Do-As`` header (the servlet's ``doAs`` parameter);
    the end user's role comes from a local user→role table."""

    DO_AS_HEADER = "X-Cruise-Control-Do-As"

    def __init__(self, proxy_credentials: Dict[str, Tuple[str, str]],
                 user_roles: Dict[str, str],
                 allowed_proxies: Optional[Iterable[str]] = None):
        self._proxy_auth = BasicSecurityProvider(proxy_credentials)
        self._proxy_names = set(allowed_proxies
                                if allowed_proxies is not None
                                else proxy_credentials)
        self._user_roles = dict(user_roles)

    def authenticate(self, headers) -> Optional[str]:
        if self._proxy_auth.authenticate(headers) is None:
            return None
        auth = headers.get("Authorization", "")
        try:
            proxy_user = base64.b64decode(auth[6:]).decode().split(":", 1)[0]
        except Exception:  # noqa: BLE001
            return None
        if proxy_user not in self._proxy_names:
            return None
        do_as = headers.get(self.DO_AS_HEADER)
        if not do_as:
            return None
        return self._user_roles.get(do_as)
