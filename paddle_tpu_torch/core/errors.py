"""Error taxonomy and enforce helpers — the port's copy of
``paddle_tpu/core/errors.py`` (``EnforceNotMet`` :28, the typed errors,
``enforce`` / ``enforce_eq`` / ``enforce_gt`` :80-96, ``tag_op_error``
:99 and ``op_error_context`` :118), after the reference's
``paddle/fluid/platform/enforce.h:422`` and ``error_codes.proto``.

The eager dispatcher (``core/dispatch.py``) tags an op's errors with its
name through :func:`tag_op_error`, so a failure deep in an op surfaces
as ``[operator < matmul > error] ...``.
"""
from __future__ import annotations

from contextlib import contextmanager

__all__ = [
    "EnforceNotMet", "InvalidArgumentError", "NotFoundError",
    "OutOfRangeError", "AlreadyExistsError", "ResourceExhaustedError",
    "PreconditionNotMetError", "PermissionDeniedError",
    "ExecutionTimeoutError", "UnimplementedError", "UnavailableError",
    "FatalError", "ExternalError", "enforce", "enforce_eq", "enforce_gt",
    "op_error_context", "tag_op_error",
]


class EnforceNotMet(RuntimeError):
    """Base — reference ``enforce.h:422`` EnforceNotMet."""

    code = "LEGACY"


class InvalidArgumentError(EnforceNotMet, ValueError):
    code = "INVALID_ARGUMENT"


class NotFoundError(EnforceNotMet, LookupError):
    code = "NOT_FOUND"


class OutOfRangeError(EnforceNotMet, IndexError):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(EnforceNotMet):
    code = "ALREADY_EXISTS"


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    code = "RESOURCE_EXHAUSTED"


class PreconditionNotMetError(EnforceNotMet):
    code = "PRECONDITION_NOT_MET"


class PermissionDeniedError(EnforceNotMet):
    code = "PERMISSION_DENIED"


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    code = "EXECUTION_TIMEOUT"


class UnimplementedError(EnforceNotMet, NotImplementedError):
    code = "UNIMPLEMENTED"


class UnavailableError(EnforceNotMet):
    code = "UNAVAILABLE"


class FatalError(EnforceNotMet):
    code = "FATAL"


class ExternalError(EnforceNotMet):
    code = "EXTERNAL"


def enforce(cond, msg="", error_cls=InvalidArgumentError):
    """PADDLE_ENFORCE: raise ``error_cls`` with message when cond is
    falsy (reference enforce.h:434)."""
    if not cond:
        raise error_cls(f"{error_cls.code}: {msg}" if msg
                        else error_cls.code)


def enforce_eq(a, b, msg="", error_cls=InvalidArgumentError):
    if a != b:
        raise error_cls(f"{error_cls.code}: expected {a!r} == {b!r}. {msg}")


def enforce_gt(a, b, msg="", error_cls=InvalidArgumentError):
    if not a > b:
        raise error_cls(f"{error_cls.code}: expected {a!r} > {b!r}. {msg}")


def tag_op_error(op_name: str, e: BaseException):
    """Convert/annotate an exception with operator context and raise it
    (reference ``framework/operator.cc`` appends the op type + callstack
    to EnforceNotMet).  Shared by dispatch() and op_error_context so the
    tagging rules live in exactly one place."""
    if isinstance(e, EnforceNotMet):
        if not getattr(e, "_op_tagged", False):
            e._op_tagged = True
            e.args = (f"[operator < {op_name} > error] {e}",) + e.args[1:]
        raise e
    # torch reports an invalid argument (a shape, a dim) as a plain
    # RuntimeError where JAX raises TypeError / ValueError
    if isinstance(e, (TypeError, ValueError, IndexError, KeyError)) or \
            type(e) is RuntimeError:
        exc = InvalidArgumentError(
            f"[operator < {op_name} > error] {type(e).__name__}: {e}")
        exc._op_tagged = True
        raise exc from e
    raise e


@contextmanager
def op_error_context(op_name: str):
    """Context-manager form of ``tag_op_error``."""
    try:
        yield
    except BaseException as e:
        tag_op_error(op_name, e)
