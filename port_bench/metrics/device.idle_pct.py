"""Share of the traced window in which no kernel, copy or fill ran on a
card, averaged over the cards the cell uses (device trace)."""


def read(r):
    if not r.devices:
        return None
    busy = sum(d["busy_s"] / d["window_s"] for d in r.devices)
    return 100.0 * (1.0 - busy / len(r.devices))
