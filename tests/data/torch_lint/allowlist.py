"""Golden snippet for the allowlist comment: each violation here carries a
``# e2a-torch: ignore[...]`` and must produce NO findings, except the last
one, whose ignore names a different rule."""
import warnings


def acknowledged_shim():
    # e2a-torch: ignore[E2A005]
    warnings.warn("old", DeprecationWarning)


def acknowledged_inline():
    warnings.warn("old", DeprecationWarning)   # e2a-torch: ignore[E2A005]


def bare_ignore():
    warnings.warn("old", category=DeprecationWarning)   # e2a-torch: ignore


def wrong_rule():
    warnings.warn("old", DeprecationWarning)   # e2a-torch: ignore[E2A001]
