"""Golden GOOD snippet for E2A005: every DeprecationWarning names its
stacklevel, so the warning lands on the user's call site."""
import warnings


def legacy_shim(backend):
    warnings.warn("backend= is deprecated; pass policy=",
                  DeprecationWarning, stacklevel=2)
    return backend


def deep_shim():
    warnings.warn("old", DeprecationWarning, 4)   # positional stacklevel


def unrelated():
    warnings.warn("not a deprecation")   # other categories: not this rule
