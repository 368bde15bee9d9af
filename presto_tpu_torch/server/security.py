"""Security: the statement server's authenticators and access control.

The counterpart of ``presto_tpu/server/security.py`` (reference
server/security/AuthenticationFilter.java with
PasswordAuthenticatorManager and the file-based authenticator of
presto-password-authenticators/.../file/FileAuthenticator.java, the JWT
authenticator of server/security/jwt; security/AccessControlManager.java
and spi/security/SystemAccessControl with the file-based catalog rules;
spi/security/RoleGrant and GrantInfo for the roles):

- ``PasswordAuthenticator``: user -> password map (or a ``user:password``
  lines file); the statement server challenges with HTTP Basic when one
  is installed.
- ``JwtAuthenticator``: HS256 bearer tokens (signature, ``exp`` and
  audience checks; the principal is the ``sub`` claim).
- ``AccessControl``: first-match catalog allow / deny rules per user::

      {"catalogs": [
          {"user": "admin", "catalog": ".*", "allow": true},
          {"catalog": "system", "allow": false},
          {"allow": true}]}

  (user and catalog are full-match regexes, both optional);
- ``RoleManager``: roles, role grants and table privileges behind CREATE
  / DROP ROLE, GRANT / REVOKE, SET ROLE and SHOW ROLES / GRANTS;
- ``SecuredCatalogs``: a catalog-manager view that checks the rules on
  every resolution, so the planner needs no security knowledge.

Standard library only (hmac, hashlib, base64), as in the reference.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional


class AccessDeniedError(PermissionError):
    pass


class PasswordAuthenticator:
    def __init__(self, users: Optional[Dict[str, str]] = None,
                 path: Optional[str] = None):
        self.users = dict(users or {})
        if path:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if line and ":" in line and not line.startswith("#"):
                        u, p = line.split(":", 1)
                        self.users[u] = p

    def authenticate(self, user: str, password: str) -> bool:
        import hmac
        expected = self.users.get(user)
        return expected is not None and hmac.compare_digest(
            expected, password)


class JwtAuthenticator:
    """Bearer-token (JWT HS256) authentication: this engine's stand-in
    for the reference's JsonWebTokenAuthenticator (reference
    server/security/jwt — signature verification + exp check, principal
    from the ``sub`` claim). Stdlib-only: HMAC-SHA256 over the signing
    input, base64url decoding, no external JOSE dependency."""

    def __init__(self, secret: str, required_audience: str = ""):
        self.secret = secret.encode("utf-8")
        self.audience = required_audience

    def authenticate(self, token: str):
        """Returns the principal (sub) or None when invalid/expired."""
        import base64
        import hashlib
        import hmac
        import json
        import time

        def b64d(s: str) -> bytes:
            return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))

        try:
            header_b64, payload_b64, sig_b64 = token.split(".")
            header = json.loads(b64d(header_b64))
            if header.get("alg") != "HS256":
                return None
            signing_input = f"{header_b64}.{payload_b64}".encode("ascii")
            expect = hmac.new(self.secret, signing_input,
                              hashlib.sha256).digest()
            if not hmac.compare_digest(expect, b64d(sig_b64)):
                return None
            claims = json.loads(b64d(payload_b64))
            if "exp" in claims and time.time() >= float(claims["exp"]):
                return None
            if self.audience:
                aud = claims.get("aud")
                auds = aud if isinstance(aud, list) else [aud]
                if self.audience not in auds:
                    return None
            return claims.get("sub")
        except Exception:
            return None

    @staticmethod
    def issue(secret: str, sub: str, exp: Optional[float] = None,
              aud: str = "") -> str:
        """Mint a token (tests / trusted internal callers)."""
        import base64
        import hashlib
        import hmac
        import json

        def b64e(b: bytes) -> str:
            return base64.urlsafe_b64encode(b).rstrip(b"=").decode()

        claims: dict = {"sub": sub}
        if exp is not None:
            claims["exp"] = exp
        if aud:
            claims["aud"] = aud
        h = b64e(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
        p = b64e(json.dumps(claims).encode())
        sig = hmac.new(secret.encode(), f"{h}.{p}".encode(),
                       hashlib.sha256).digest()
        return f"{h}.{p}.{b64e(sig)}"


class RoleManager:
    """Roles, role grants, and table privileges (reference
    spi/security/RoleGrant + GrantInfo, AccessControlManager grant
    paths; the SQL surface is CREATE/DROP ROLE, GRANT/REVOKE,
    SET ROLE, SHOW ROLES/GRANTS).

    Enforcement model: permissive until ``enforce`` is set (matching
    the engine's default-open access control); when enforcing, a user
    must hold a privilege directly or through a granted role, and the
    built-in ``admin`` role bypasses checks and gates role/grant
    management."""

    ADMIN = "admin"

    def __init__(self, enforce: bool = False):
        self.enforce = enforce
        self.roles: set = {self.ADMIN}
        self.user_roles: Dict[str, set] = {}
        # (grantee, catalog, table) -> set of privileges
        self.table_grants: Dict[tuple, set] = {}

    # -- management (admin-gated when enforcing) -----------------------------
    def _check_admin(self, user: str) -> None:
        if self.enforce and not self.is_admin(user):
            raise AccessDeniedError(
                f"Access Denied: {user!r} is not in the admin role")

    def is_admin(self, user: str) -> bool:
        return self.ADMIN in self.user_roles.get(user, set())

    def create_role(self, name: str, user: str) -> None:
        self._check_admin(user)
        if name in self.roles:
            raise ValueError(f"role {name!r} already exists")
        self.roles.add(name)

    def drop_role(self, name: str, user: str) -> None:
        self._check_admin(user)
        if name == self.ADMIN:
            raise ValueError("cannot drop the admin role")
        self.roles.discard(name)
        for rs in self.user_roles.values():
            rs.discard(name)

    def grant_roles(self, roles, grantees, user: str) -> None:
        self._check_admin(user)
        for r in roles:
            if r not in self.roles:
                raise ValueError(f"role {r!r} does not exist")
            for g in grantees:
                self.user_roles.setdefault(g, set()).add(r)

    def revoke_roles(self, roles, grantees, user: str) -> None:
        self._check_admin(user)
        for g in grantees:
            for r in roles:
                self.user_roles.get(g, set()).discard(r)

    def grant_table(self, privileges, catalog: str, table: str,
                    grantee: str, user: str) -> None:
        self._check_admin(user)
        key = (grantee, catalog, table)
        self.table_grants.setdefault(key, set()).update(
            p.upper() for p in privileges)

    def revoke_table(self, privileges, catalog: str, table: str,
                     grantee: str, user: str) -> None:
        self._check_admin(user)
        key = (grantee, catalog, table)
        have = self.table_grants.get(key)
        if have:
            have.difference_update(p.upper() for p in privileges)

    # -- checks --------------------------------------------------------------
    def _grantees_of(self, user: str):
        return {user} | self.user_roles.get(user, set())

    def has_table_privilege(self, user: str, catalog: str, table: str,
                            privilege: str) -> bool:
        if not self.enforce or self.is_admin(user):
            return True
        p = privilege.upper()
        for g in self._grantees_of(user):
            if p in self.table_grants.get((g, catalog, table), set()):
                return True
        return False

    def check_table_privilege(self, user: str, catalog: str, table: str,
                              privilege: str) -> None:
        if not self.has_table_privilege(user, catalog, table, privilege):
            raise AccessDeniedError(
                f"Access Denied: user {user!r} lacks {privilege} on "
                f"{catalog}.{table}")

    # -- listings ------------------------------------------------------------
    def list_roles(self):
        return sorted(self.roles)

    def list_grants(self, table=None):
        out = []
        for (g, cat, tab), privs in sorted(self.table_grants.items()):
            if table is not None and (cat, tab) != table:
                continue
            for p in sorted(privs):
                out.append((g, cat, tab, p))
        return out


class AccessControl:
    """First-match catalog rules; default-deny when rules exist, the
    permissive allow-all when constructed with no rules."""

    def __init__(self, rules: Optional[dict] = None):
        self.catalog_rules: List[dict] = \
            list((rules or {}).get("catalogs", []))

    def can_access_catalog(self, user: str, catalog: str) -> bool:
        if not self.catalog_rules:
            return True
        for rule in self.catalog_rules:
            if "user" in rule and not re.fullmatch(rule["user"],
                                                   user or ""):
                continue
            if "catalog" in rule and not re.fullmatch(rule["catalog"],
                                                      catalog):
                continue
            return bool(rule.get("allow", True))
        return False

    def check_can_access_catalog(self, user: str, catalog: str) -> None:
        if not self.can_access_catalog(user, catalog):
            raise AccessDeniedError(
                f"Access Denied: user {user!r} cannot access catalog "
                f"{catalog!r}")

    def filter_catalogs(self, user: str, catalogs: List[str]) -> List[str]:
        return [c for c in catalogs if self.can_access_catalog(user, c)]


class SecuredCatalogs:
    """CatalogManager view that enforces access control on every
    resolution — the planner/executor path needs no security knowledge
    (the reference injects this the same way: MetadataManager resolves
    through AccessControl-checked connectors)."""

    def __init__(self, inner, user: str, access_control: AccessControl):
        self._inner = inner
        self._user = user
        self._ac = access_control

    def get(self, name: str):
        self._ac.check_can_access_catalog(self._user, name)
        return self._inner.get(name)

    def names(self) -> List[str]:
        return self._ac.filter_catalogs(self._user, self._inner.names())

    def exists(self, name: str) -> bool:
        return self._inner.exists(name)

    def register(self, name: str, connector) -> None:
        self._inner.register(name, connector)
