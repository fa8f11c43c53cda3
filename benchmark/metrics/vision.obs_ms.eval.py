"""``vision.obs_ms.eval``: host ms of one ``envs/vision.render_obs`` call
(the ``vision.render_obs`` span: scene primitives, B2's render, the
unprojection and B3's FPS), median over the traced run."""

import statistics


def read(run):
    v = run.spans.durations("vision.render_obs")
    return statistics.median(v) * 1e3 if v else None
