"""The reader of `patched_flatten_pct` (`metrics/patched_flatten_pct.py`)
on hand-made records: the share of the window's `merge.flatten` spans
that hold a `flatten.patch` span, None without merges, and None against
a program that declares no such span."""

import pytest

from dilibench import manifest as M
from dilibench.trace import CallRec, Records

NAME = "patched_flatten_pct"


def _records(patched):
    """A write call whose two merges each flatten once; the `i`th
    `merge.flatten` holds a `flatten.patch` span where `patched[i]`."""
    spans = [("merge.fold", 0.0025, 0.0005)]
    for (a, b), p in zip([(0.003, 0.004), (0.008, 0.009)], patched):
        spans.append(("merge.flatten", a, b - a))
        if p:
            spans.append(("flatten.patch", a + 0.0001, 0.0005))
    spans.append(("merge.publish", 0.0095, 0.0003))
    calls = [CallRec("upsert", 0.002, 0.010, 512, 0, True)]
    return Records("x", 10.0, 8.0, (0.0, 0.010), calls,
                   merges=len(patched), spans=spans)


@pytest.mark.parametrize("patched, want", [((True, True), 100.0),
                                           ((False, True), 50.0),
                                           ((True, False), 50.0),
                                           ((False, False), 0.0)])
def test_share_of_flattens_that_patched(patched, want):
    assert M.reader(NAME)(_records(patched)) == pytest.approx(want)


def test_none_without_merges():
    rec = Records("x", 10.0, 8.0, (0.0, 0.010),
                  [CallRec("lookup", 0.0, 0.001, 512, 0, True)],
                  spans=[("lookup.check", 0.0, 0.0001)])
    assert M.reader(NAME)(rec) is None


def test_patch_span_outside_every_flatten_counts_for_none():
    rec = _records((False, False))
    rec.spans.append(("flatten.patch", 0.0050, 0.0005))
    assert M.reader(NAME)(rec) == 0.0


def test_none_against_a_program_without_the_span(monkeypatch):
    from repro_torch.obs import tracing
    monkeypatch.delattr(tracing, "PATCH_STAGES")
    assert M.reader(NAME)(_records((True, True))) is None
