"""Set-up: host seconds of the port's graph build (``ops/graph_format.py:
build_graph`` with the self-loops, the hub that ``hub_cache`` resolves to,
and the copy to the card), inside set-up."""


def read(ctx):
    return ctx.graph_build_s
