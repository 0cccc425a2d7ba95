"""The cells' drivers, one module a kind of work, and what they share."""
import contextlib


@contextlib.contextmanager
def patched(pairs):
    """Replace attributes for a while: ``pairs`` of (object, name,
    make(original) -> replacement), the original being what the object
    gives now (a method, or a wrapper already in place); each put back
    after."""
    saved = []
    try:
        for obj, name, make in pairs:
            saved.append((obj, name, vars(obj).get(name), name in vars(obj)))
            setattr(obj, name, make(getattr(obj, name)))
        yield
    finally:
        for obj, name, old, had in reversed(saved):
            if had:
                setattr(obj, name, old)
            else:
                delattr(obj, name)
