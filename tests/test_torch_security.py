"""Access control of presto_tpu_torch against presto_tpu: catalog rules,
roles and grants, the secured CTAS source and per-user transactions (the
corresponding cases of tests/test_security.py; the password and JWT
authenticators belong to the HTTP server, which is not ported). At
TPC-H SF 0.001 on the CPU; every statement runs through both runners and
must give the same rows, or the same error."""
import pytest

from presto_tpu.exec.runner import LocalRunner as JRunner
from presto_tpu.server.security import AccessControl as JAccessControl
from presto_tpu_torch.exec.runner import LocalRunner
from presto_tpu_torch.server.security import (
    AccessControl, AccessDeniedError, RoleManager, SecuredCatalogs,
)

SF = 0.001

RULES = {"catalogs": [
    {"user": "admin", "catalog": ".*", "allow": True},
    {"catalog": "system", "allow": False},
    {"allow": True}]}


def _pair():
    return JRunner(tpch_sf=SF), LocalRunner(tpch_sf=SF, device="cpu")


def both(pair, sql, **kw):
    """The port's rows, asserted equal to the reference's; or the error
    both raised (the same class name and message)."""
    out = []
    for r in pair:
        try:
            out.append([tuple(x) for x in r.execute(sql, **kw).rows])
        except Exception as e:  # noqa: BLE001 - compared below
            out.append(e)
    want, got = out
    if isinstance(want, Exception) or isinstance(got, Exception):
        assert type(got).__name__ == type(want).__name__, (want, got)
        assert str(got) == str(want)
    else:
        assert got == want
    return got


def test_access_control_rules():
    for cls in (AccessControl, JAccessControl):
        ac = cls(RULES)
        assert ac.can_access_catalog("admin", "system")
        assert not ac.can_access_catalog("jane", "system")
        assert ac.can_access_catalog("jane", "tpch")
        assert ac.filter_catalogs("jane", ["tpch", "system"]) == ["tpch"]
    assert AccessControl().can_access_catalog("anyone", "system")


def test_secured_catalogs_view():
    r = LocalRunner(tpch_sf=SF, device="cpu")
    view = SecuredCatalogs(r.session.catalogs, "jane", AccessControl(RULES))
    assert "system" not in view.names() and "tpch" in view.names()
    assert view.exists("system")
    with pytest.raises(AccessDeniedError, match="cannot access catalog"):
        view.get("system")


def test_runner_enforces_catalog_rules():
    pair = _pair()
    for r, cls in zip(pair, (JAccessControl, AccessControl)):
        r.access_control = cls({"catalogs": [
            {"user": "admin", "allow": True},
            {"catalog": "tpch", "allow": True},
            {"allow": False}]})
    assert both(pair, "select count(*) from nation", user="jane") == [(25,)]
    err = both(pair, "select * from system.default.catalogs", user="jane")
    assert isinstance(err, AccessDeniedError)
    rows = both(pair, "select * from system.default.catalogs", user="admin")
    assert ("tpch",) in rows
    # SHOW CATALOGS is filtered, not failed
    assert both(pair, "show catalogs", user="jane") == [("tpch",)]
    err = both(pair, "create table memory.default.t as select 1 a",
               user="jane")
    assert isinstance(err, AccessDeniedError)


def test_ctas_insert_source_is_secured():
    """INSERT INTO an allowed catalog SELECT FROM a denied one fails: the
    source query plans against the secured session too."""
    pair = _pair()
    for r, cls in zip(pair, (JAccessControl, AccessControl)):
        r.access_control = cls({"catalogs": [
            {"catalog": "memory", "allow": True}, {"allow": False}]})
    err = both(pair, "create table memory.default.steal as "
                     "select * from tpch.default.nation", user="bob")
    assert isinstance(err, AccessDeniedError)


def test_per_user_transactions():
    """One user's BEGIN must not scope (or roll back) another user's
    auto-commit writes."""
    pair = _pair()
    for r in pair:
        r.execute("start transaction", user="alice")
    both(pair, "create table memory.default.bobt as select 1 a", user="bob")
    both(pair, "rollback", user="alice")
    assert both(pair, "select count(*) from memory.default.bobt",
                user="bob") == [(1,)]


def test_roles_and_grants_sql_surface():
    pair = _pair()
    both(pair, "create role analyst")
    assert ("analyst",) in both(pair, "show roles")
    both(pair, "grant analyst to user alice")
    both(pair, "grant select on nation to analyst")
    assert ("analyst", "tpch", "nation", "SELECT") in \
        both(pair, "show grants on nation")
    both(pair, "revoke select on nation from analyst")
    assert both(pair, "show grants on nation") == []
    both(pair, "revoke analyst from user alice")
    both(pair, "drop role analyst")
    assert ("analyst",) not in both(pair, "show roles")
    err = both(pair, "drop role admin")
    assert isinstance(err, ValueError)
    both(pair, "set role all")
    assert pair[1].session.properties["role"] == "all"


def test_table_privilege_enforcement():
    """With enforcement on, SELECT needs a grant (direct or through a
    role); admin bypasses the checks and gates role management; writes
    need INSERT."""
    pair = _pair()
    for r in pair:
        r.roles.enforce = True
        r.roles.user_roles["boss"] = {"admin"}
    assert both(pair, "select count(*) from region", user="boss")
    both(pair, "create role readers", user="boss")
    both(pair, "grant readers to user carol", user="boss")
    both(pair, "grant select on region to readers", user="boss")
    assert both(pair, "select count(*) from region", user="carol") == [(5,)]
    for sql in ("select count(*) from nation", "create role hackers",
                "create table memory.default.t1 as select * from region"):
        assert isinstance(both(pair, sql, user="carol"), AccessDeniedError)
    both(pair, "grant insert on memory.default.t1 to carol", user="boss")
    both(pair, "grant select on region to carol", user="boss")
    assert both(pair, "create table memory.t1 as select * from region",
                user="carol") == [(5,)]


def test_role_manager_unit():
    rm = RoleManager(enforce=True)
    rm.user_roles["root"] = {"admin"}
    rm.create_role("r", "root")
    with pytest.raises(ValueError, match="already exists"):
        rm.create_role("r", "root")
    rm.grant_roles(["r"], ["u"], "root")
    rm.grant_table(["select"], "tpch", "nation", "r", "root")
    assert rm.has_table_privilege("u", "tpch", "nation", "SELECT")
    assert not rm.has_table_privilege("u", "tpch", "region", "SELECT")
    assert rm.list_grants(("tpch", "nation")) == [
        ("r", "tpch", "nation", "SELECT")]
    rm.drop_role("r", "root")
    assert not rm.has_table_privilege("u", "tpch", "nation", "SELECT")
