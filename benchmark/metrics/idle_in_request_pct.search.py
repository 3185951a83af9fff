"""idle_in_request_pct.search: the share of the traced stretch's
in-request time (some request inside its call to the program) in which
no kernel and no copy ran on the card: how far the host holds the card
back while it serves (device trace and the benchmark's request spans).
The gaps of the open-loop schedule, with no request in flight, are left
out: they are set by the offered rate, not by the program."""


def read(ctx):
    s = ctx.trace_summary
    if s is None or not ctx.requests or s["busy_s"] <= 0 or s["request_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_in_request_s"] / s["request_s"])
