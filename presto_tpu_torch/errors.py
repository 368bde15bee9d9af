"""Query error codes raised by device-side kernels.

The analogue of Presto's StandardErrorCode + PrestoException (reference
presto-spi/.../spi/StandardErrorCode.java): kernels cannot raise inside a
jitted program, so scalar functions record a per-row int32 error code on the
evaluated value (0 = ok), compiled filter/projection kernels reduce it to a
per-batch scalar (max over live rows), and the executor checks the collected
scalars once per query — one host sync — raising ``QueryError`` with the
Presto error name. ``TRY(expr)`` clears the codes and yields NULL for the
failed rows (reference operator/scalar/TryFunction.java).
"""
from __future__ import annotations

DIVISION_BY_ZERO = 1
NUMERIC_VALUE_OUT_OF_RANGE = 2
INVALID_FUNCTION_ARGUMENT = 3
GENERIC_USER_ERROR = 4
# a group key fell outside the range its connector statistics promised
# (stats-bounded dense grouping, optimizer._attach_group_bounds): the
# dense slot code would be garbage, so the query fails loudly instead of
# returning misgrouped rows
STATS_BOUND_VIOLATION = 5

ERROR_NAMES = {
    DIVISION_BY_ZERO: "DIVISION_BY_ZERO",
    NUMERIC_VALUE_OUT_OF_RANGE: "NUMERIC_VALUE_OUT_OF_RANGE",
    INVALID_FUNCTION_ARGUMENT: "INVALID_FUNCTION_ARGUMENT",
    GENERIC_USER_ERROR: "GENERIC_USER_ERROR",
    STATS_BOUND_VIOLATION: "STATS_BOUND_VIOLATION",
}


class QueryError(RuntimeError):
    """A row-level evaluation error surfaced at query granularity."""

    def __init__(self, code: int, message: str | None = None):
        self.code = code
        self.name = ERROR_NAMES.get(code, f"ERROR_{code}")
        super().__init__(message or self.name)


class QueryCancelledError(RuntimeError):
    """Raised by the executor when a cancel request interrupts a running
    query between batch quanta (the role of the reference's
    dispatcher/DispatchManager.java:134 cancel semantics: a DELETE on the
    statement URI must stop in-flight work, not just mark state)."""

    def __init__(self, message: str = "Query was canceled"):
        super().__init__(message)
