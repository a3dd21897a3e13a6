"""Host data (``data/pipeline.py`` DataLoader, its producer thread): mean
ms of the program's ``mmalz.loader.collate`` spans that start in the traced
stretch, on any thread: stacking a batch's samples into its (pinned)
buffers, the padding and the mask."""

from benchmark.lib import spans


def read(ctx):
    if not ctx.get("trace"):
        return None
    return spans.mean_ms(spans.named(ctx["trace"], spans.LOADER_COLLATE))
