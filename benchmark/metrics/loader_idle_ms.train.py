"""Host data (``data/pipeline.py`` DataLoader): ms a traced step that the
device sat idle while the caller waited in the program's
``mmalz.loader.wait`` spans for a batch that was not ready; 0 where the
loader never kept it waiting."""

from benchmark.lib import spans


def read(ctx):
    return spans.caller_idle_ms(ctx, spans.LOADER_WAIT)
