"""serve.rows_per_dispatch: requests a dispatch of the service over the window (its own served and dispatches counters)."""


def read(r):
    return r.window["served"] / r.window["dispatches"] if r.window["dispatches"] else None
