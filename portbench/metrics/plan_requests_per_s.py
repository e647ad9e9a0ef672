"""Plan requests completed in the window over the window's seconds."""


def read(run):
    done = sum(c.requests for c in run.completed())
    return done / run.window_s if run.window_s > 0 else None
