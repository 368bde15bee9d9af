"""Transactions: session-scoped atomic writes over transactional catalogs.

The counterpart of ``presto_tpu/transaction.py`` (the role of the
reference's transaction layer, presto-main/.../transaction/
InMemoryTransactionManager.java:168,174: transaction scope across
connectors, isolation level and read-only modes, auto-commit for single
statements). BEGIN snapshots a transactional connector on its first
write, writes apply at once (read-your-writes), ROLLBACK restores the
snapshot and COMMIT drops it. Connectors opt in with
``transaction_snapshot()`` / ``transaction_restore(snap)``; a write to a
catalog without them inside an explicit transaction fails, as the
reference's single-writable-catalog check does.
"""
from __future__ import annotations

import secrets
from typing import Dict


class TransactionError(RuntimeError):
    pass


class Transaction:
    def __init__(self, tx_id: str, isolation: str, read_only: bool):
        self.id = tx_id
        self.isolation = isolation
        self.read_only = read_only
        # catalog name -> (connector, snapshot taken before first write)
        self.snapshots: Dict[str, tuple] = {}


class TransactionManager:
    """One explicit transaction per session key (the user on a shared
    server; "" for the embedded single-session runner — the CLI/JDBC
    model); every statement outside an explicit transaction
    auto-commits. One user's BEGIN must never scope another user's
    writes."""

    def __init__(self) -> None:
        self._current: Dict[str, Transaction] = {}

    def active(self, user: str = "") -> bool:
        return user in self._current

    def begin(self, isolation: str = "READ COMMITTED",
              read_only: bool = False, user: str = "") -> str:
        if user in self._current:
            raise TransactionError("transaction already in progress")
        tx = Transaction(f"tx_{secrets.token_hex(8)}", isolation,
                         read_only)
        self._current[user] = tx
        return tx.id

    def touch_for_write(self, catalog: str, connector,
                        user: str = "") -> None:
        """Before the first write to ``catalog`` in this user's
        transaction: check writability and capture the connector
        snapshot that ROLLBACK restores."""
        tx = self._current.get(user)
        if tx is None:
            return                       # auto-commit statement
        if tx.read_only:
            raise TransactionError("read-only transaction")
        if catalog in tx.snapshots:
            return
        snap_fn = getattr(connector, "transaction_snapshot", None)
        if snap_fn is None:
            raise TransactionError(
                f"catalog {catalog!r} does not support transactions")
        tx.snapshots[catalog] = (connector, snap_fn())

    def commit(self, user: str = "") -> None:
        if user not in self._current:
            raise TransactionError("no transaction in progress")
        del self._current[user]          # writes already applied

    def rollback(self, user: str = "") -> None:
        tx = self._current.get(user)
        if tx is None:
            raise TransactionError("no transaction in progress")
        for connector, snap in tx.snapshots.values():
            connector.transaction_restore(snap)
        del self._current[user]
