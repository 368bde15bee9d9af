from .parser import parse_statement  # noqa: F401
