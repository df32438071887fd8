"""Milliseconds per pretraining step that the window spent in ``next()`` on
the feed (the benchmark's own span around each call), summed over the
window and divided by its steps.  The pretraining mix keeps every triplet
in RAM (the CLI's ``--cache_tiles``, filled in set-up), so this times the
cached feed (stacking, pinning, the copy to the card), not the sampler's
reads from the slides."""


def read(ctx):
    if ctx["stage"] != "pretrain":
        return None
    w = ctx["window"]
    return 1e3 * w["feed_wait_s"] / w["steps"]
