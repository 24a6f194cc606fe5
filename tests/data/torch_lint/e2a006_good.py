"""Golden GOOD snippet for E2A006: every broad handler actually handles —
narrows the type, re-raises, logs, or substitutes an explicit fallback."""
import logging

logger = logging.getLogger(__name__)


def narrow_type(fn):
    try:
        return fn()
    except ValueError:   # concrete type: swallowing it is a local decision
        pass


def broad_but_handled(fn):
    try:
        return fn()
    except Exception as e:
        logger.warning("fn failed: %s", e)   # surfaced, not swallowed
        return None


def broad_fallback(fn, default):
    try:
        return fn()
    except Exception:
        return default   # explicit fallback value, not a silent no-op


def broad_reraise(fn):
    try:
        return fn()
    except Exception as e:
        raise RuntimeError("fn failed") from e


def deliberate_swallow(fn):
    try:
        return fn()
    except Exception:   # e2a-torch: ignore[E2A006] - best-effort probe only
        pass
