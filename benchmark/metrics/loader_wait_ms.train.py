"""Host data (``data/pipeline.py`` DataLoader): mean ms a step that the
window waited in ``next(loader)``, by the benchmark's timer."""


def read(ctx):
    return ctx.get("loader_wait_ms")
