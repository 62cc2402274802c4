"""Host time inside the entry's calls (pinning, copies enqueued, graph
replays enqueued, clones), per pair, ms: the window's calls made once more
just before it, untraced, so that the profiler's own host cost is not in
it."""


def read(ctx):
    plain = ctx["plain"]
    if plain is None or not plain.pairs:
        return None
    return plain.entry_s * 1e3 / plain.pairs
