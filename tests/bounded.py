"""A bounded wait for the tests that fork: run a call in a thread and fail,
rather than hang, when it has not returned in time."""

import threading


def within(seconds: float, fn):
    """fn() in a daemon thread; its result, or its exception re-raised; an
    AssertionError if it has not returned within `seconds`."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            box["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"no result within {seconds} s"
    if "error" in box:
        raise box["error"]
    return box["value"]
