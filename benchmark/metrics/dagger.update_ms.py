"""``dagger.update_ms``: host ms of a DAgger iteration's update, the
``dagger.iteration`` span (``_dagger_iteration`` and ``fetch_scalars``)
less its ``dagger.collect`` span, median over the traced run's
iterations."""

import statistics


def read(run):
    v = run.spans.self_ms("dagger.iteration", "dagger.collect")
    return statistics.median(v) if v else None
