"""Kernel 5's front-wait share (``metrics/k5_front_wait_share.py``)
against hand counts of the port's counters ``k5_tiles`` and
``k5_front_waits``."""
import pytest

from test_iqbench_yields import metric


def with_counters(monkeypatch, counts):
    """The reader with the port's counters replaced by ``counts`` (a name
    missing from it: the port kept no such counter or it counted 0)."""
    reader = metric("k5_front_wait_share")
    monkeypatch.setattr(reader, "port_counter", lambda name: counts.get(name))
    return reader


@pytest.mark.parametrize("tiles,waits,share", [
    (400, 100, 25.0), (7, 7, 100.0), (3, 1, 100.0 / 3)])
def test_share_of_tiles_waited_for(monkeypatch, tiles, waits, share):
    reader = with_counters(monkeypatch, {"k5_tiles": tiles, "k5_front_waits": waits})
    got = reader.read(None)
    assert got == pytest.approx(share)
    assert 0.0 <= got <= 100.0


def test_no_wait_counted_reads_zero(monkeypatch):
    """``port_counter`` gives None for a counter that counted 0."""
    reader = with_counters(monkeypatch, {"k5_tiles": 512})
    assert reader.read(None) == 0.0


def test_without_tiles_reads_none(monkeypatch):
    """A port without the pipeline's counters (the parent's) reads None."""
    assert with_counters(monkeypatch, {}).read(None) is None
    assert with_counters(monkeypatch, {"k5_rows": 99}).read(None) is None
