"""text_graph_pct.search: the share of the window's text-tower calls
(the ``embed.text`` timer's count) that replayed the tower's CUDA graph
(the program's ``embed.text_graph_replay`` counter), in percent: 100 where
every call took the graph. A call of more than one chunk (over 512 texts)
replays once a chunk. None where the program has no such counter."""


def read(ctx):
    n = ctx.program_metrics.get("counters", {}).get("embed.text_graph_replay")
    t = ctx.program_metrics.get("timings", {}).get("embed.text")
    if not ctx.requests or n is None or not t or not t["count"]:
        return None
    return 100.0 * n / t["count"]
