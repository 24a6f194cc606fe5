"""Golden BAD snippet for E2A006: fault-swallowing exception handlers."""


def swallow_pass(fn):
    try:
        return fn()
    except Exception:   # BAD: fault disappears silently
        pass


def swallow_ellipsis(fn):
    try:
        return fn()
    except BaseException:   # BAD: even SystemExit vanishes
        ...


def swallow_in_loop(items):
    out = []
    for it in items:
        try:
            out.append(it())
        except Exception:   # BAD: per-item faults dropped on the floor
            continue
    return out


def bare_handler(fn):
    try:
        return fn()
    except:   # BAD: bare except, regardless of what the body does
        raise RuntimeError("wrapped")


def broad_in_tuple(fn):
    try:
        return fn()
    except (ValueError, Exception):   # BAD: the tuple still catches all
        pass
