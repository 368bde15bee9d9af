from .ir import (  # noqa: F401
    Expr, InputRef, Literal, Call, Cast, SpecialForm, Form,
    input_ref, lit, call, cast,
)
