"""Golden BAD snippet for E2A005: DeprecationWarning without an explicit
stacklevel (points the user at repro internals)."""
import warnings


def legacy_shim(backend):
    warnings.warn("backend= is deprecated; pass policy=",
                  DeprecationWarning)   # BAD: defaults to stacklevel=1
    return backend


def keyword_form():
    warnings.warn("old", category=DeprecationWarning)   # BAD
