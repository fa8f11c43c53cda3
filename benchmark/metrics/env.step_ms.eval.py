"""Host ms of one ``env.step`` call (the ``env.step`` span), median over
the traced run."""

import statistics


def read(run):
    v = run.spans.durations("env.step")
    return statistics.median(v) * 1e3 if v else None
