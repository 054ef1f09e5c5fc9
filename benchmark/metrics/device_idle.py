"""Share of the traced window in which no kernel, copy or fill ran on the
card, in percent."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["events"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
