"""The readers of the program's spans and counters on a hand-filled
registry."""

import pytest

from port_bench import manifest
from port_bench.core import Readings
from stereo_match_tpu_torch.utils import profiling

SPANS = {"entry.upload_ms": "smt.upload", "cost.host_ms": "smt.cost",
         "sgm.host_ms": "smt.sgm", "wta.host_ms": "smt.wta"}


def readings(frames):
    return Readings(cell="census_kitti.seq", config={}, traffic={},
                    frames=frames)


def fill(monkeypatch, spans, counters):
    monkeypatch.setattr(profiling, "spans", spans)
    monkeypatch.setattr(profiling, "counters", counters)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_reader(monkeypatch, metric):
    fill(monkeypatch, {SPANS[metric]: {"calls": 8, "ns": 24_000_000},
                       "smt.other": {"calls": 1, "ns": 1}}, {})
    assert manifest.reader(metric)(readings(8)) == pytest.approx(3.0)
    assert manifest.reader(metric)(readings(0)) is None


def test_upload_reader_divides_by_the_programs_frames(monkeypatch):
    fill(monkeypatch, {}, {"frames": 10, "upload_bytes": 10 * 3_726_000})
    read = manifest.reader("entry.upload_mb")
    assert read(readings(4)) == pytest.approx(3.726)
    fill(monkeypatch, {}, {"frames": 10, "upload_bytes": 0})
    assert read(readings(4)) == 0.0


@pytest.mark.parametrize("metric", sorted(SPANS) + ["entry.upload_mb"])
def test_readers_find_nothing(monkeypatch, metric):
    read = manifest.reader(metric)
    fill(monkeypatch, {}, {})
    assert read(readings(8)) is None
    fill(monkeypatch, {}, {"upload_bytes": 5})
    assert read(readings(8)) is None
    # a program older than its registry
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counters")
    assert read(readings(8)) is None
