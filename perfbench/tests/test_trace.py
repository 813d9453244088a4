"""The reduction of a traced window's events, on hand-made events."""
from types import SimpleNamespace

from perfbench import trace


class Ev:
    def __init__(self, dev, name, lo, dur, corr=0, linked=0, tid=1,
                 annotation=False):
        self.dev, self._name, self.lo, self.dur = dev, name, lo, dur
        self.corr, self.linked, self.tid = corr, linked, tid
        self.annotation = annotation

    def device_type(self):
        return SimpleNamespace(name=self.dev)

    def name(self):
        return self._name

    def start_ns(self):
        return self.lo

    def duration_ns(self):
        return self.dur

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def is_user_annotation(self):
        return self.annotation

    def is_hidden_event(self):
        return False

    def start_thread_id(self):
        return self.tid


def test_busy_union_gaps_and_attribution():
    events = [
        # host: the window and a backbone range inside it
        Ev("CPU", trace.WINDOW, 100, 1000, annotation=True),
        Ev("CPU", "ngm.backbone", 150, 100, annotation=True),
        # launches: a primer add before the window, two in the backbone,
        # one after it
        Ev("CPU", "cudaLaunchKernel", 50, 5, corr=1),
        Ev("CPU", "cudaLaunchKernel", 160, 5, corr=2),
        Ev("CPU", "cudaLaunchKernel", 170, 5, corr=3),
        Ev("CPU", "cudaLaunchKernel", 400, 5, corr=4),
        # device: the add, two overlapping kernels, a gap, one more
        Ev("CUDA", "add", 120, 10, linked=1),
        Ev("CUDA", "conv", 200, 100, linked=2),
        Ev("CUDA", "conv", 250, 100, linked=3),
        Ev("CUDA", "sinkhorn", 500, 50, linked=4),
    ]
    red = trace.reduce_events(events, main_thread=1)
    assert red["launches"] == 3                    # the primer add left out
    assert red["busy_s"] == (150 + 50) / 1e9      # [200, 350] and [500, 550]
    assert red["by_range"] == {"ngm.backbone": 200 / 1e9,
                               trace.WINDOW: 50 / 1e9}
    assert red["gaps"] == {trace.WINDOW: 150 / 1e9}
    assert red["by_name"]["conv"] == [2, 200 / 1e9]
    b = trace.breakdown(dict(red, window_s=1.0))
    assert b["device_ops"][0] == ["conv", 200 / 1e9]
    assert b["idle_gaps"] == [[trace.WINDOW, 150 / 1e9]]
