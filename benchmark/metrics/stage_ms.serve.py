"""Predictor staging (``inference/predictor.py`` stage_sample, through
``BatchingServer.submit``): the clients' mean host ms in a ``submit``
call."""


def read(ctx):
    return ctx.get("stage_ms")
