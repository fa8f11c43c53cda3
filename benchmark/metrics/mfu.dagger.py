"""The whole step's share of the card's peak: the least time of the
window's counted work (the networks' matrix products at the peak of the
precision they compute in, the kernels' counted operations at the f32
peak; eager glue not counted) over the window's length, in %."""


def read(run):
    least = run.work.get("least_s_per_unit")
    if not least or not run.window.get("seconds"):
        return None
    return 100.0 * least * run.window["units"] / run.window["seconds"]
