"""Share of the traced samples' wall in which no kernel, copy or set ran on
the card: one minus the union of the device intervals over the window."""


def read(run):
    t = run["trace"]
    if not t or not t["device_events"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
