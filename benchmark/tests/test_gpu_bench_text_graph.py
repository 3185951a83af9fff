"""The reader of ``text_graph_pct.search``: None where the program has no
graph counter (a program without the text tower's CUDA graph, or a run on
the CPU), 100 where every text-tower call replayed the graph."""

import pytest

from benchmark.lib.spec import Spec
from gpu_bench_support import REPO


class Ctx:
    requests = [{}]

    def __init__(self, counters, calls):
        self.program_metrics = {"counters": counters, "timings": {"embed.text": {"count": calls, "total_s": 0.1}}}


@pytest.fixture(scope="module")
def read():
    return Spec(REPO).reader("text_graph_pct.search")


def test_none_without_the_counter(read):
    assert read(Ctx({"embed.text_cache_hit": 3}, 40)) is None


def test_hundred_when_every_call_replays(read):
    assert read(Ctx({"embed.text_graph_replay": 40, "embed.text_graph_capture": 0}, 40)) == pytest.approx(100.0)


def test_share_of_calls(read):
    assert read(Ctx({"embed.text_graph_replay": 30}, 40)) == pytest.approx(75.0)
