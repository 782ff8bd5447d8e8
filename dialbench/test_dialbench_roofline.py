"""The roofline counts at the fleet's shapes, and their bounds."""

from __future__ import annotations

import pytest

from dialbench import roofline


def test_segment_sum_at_the_fleets_ost_map():
    # E = 8,192 interfaces onto S = 32 OSTs, one column: 8 B a value,
    # 4 B a position, 33 int32 offsets, 32 float64 sums out
    c = roofline.segment_sum(cols=1, entries=8192, segments=32)
    assert c == {"bytes": 65536 + 32768 + 132 + 256, "ops": 8192,
                 "type": "float64"}
    t, kind = roofline.bound(c)
    assert kind == "bytes" and t == pytest.approx(98692 / 3.35e12)


def test_segment_sum_columns_share_the_map():
    one = roofline.segment_sum(1, 8192, 32)
    two = roofline.segment_sum(2, 8192, 32)
    assert two["bytes"] - one["bytes"] == 8 * 8192 + 8 * 32
    assert two["ops"] == 2 * one["ops"]


def test_paired_forest_at_the_fleets_rows():
    # 196,608 rows = 8,192 interfaces x 24 configurations, 36 float32
    # features, two forests of 160 depth-5 trees
    c = roofline.forest(rows=196608, features=36, forests=2, trees=160,
                        depth=5)
    model = 2 * 160 * (31 * 4 + 31 * 4 + 32 * 4) + 2 * 4
    assert model == 120328
    assert c["bytes"] == 196608 * 36 * 4 + 196608 * 4 + model + 196608 * 4
    assert c["ops"] == 196608 * (160 * 6 + 1)
    t, kind = roofline.bound(c)
    assert kind == "bytes" and t == pytest.approx(c["bytes"] / 3.35e12)
    assert 8.9e-6 < t < 9.0e-6


def test_lab_rows_are_four_times_the_fleets():
    fleet = roofline.forest(196608, 36, 2, 160, 5)
    lab = roofline.forest(786432, 36, 2, 160, 5)
    assert lab["ops"] == 4 * fleet["ops"]


def test_operations_bound_when_bytes_are_few():
    c = {"bytes": 1, "ops": 34e6, "type": "float64"}
    t, kind = roofline.bound(c)
    assert kind == "operations" and t == pytest.approx(1e-6)


def test_bound_s_sums_a_kernels_launches():
    launches = [("segment_sum", {"cols": 1, "entries": 8192,
                                 "segments": 32}),
                ("segment_sum", {"cols": 2, "entries": 8192,
                                 "segments": 32}),
                ("forest", {"rows": 24, "features": 36, "forests": 2,
                            "trees": 160, "depth": 5, "paired": True})]
    n, t = roofline.bound_s(launches, "segment_sum")
    assert n == 2
    assert t == pytest.approx(
        sum(roofline.bound(roofline.segment_sum(k, 8192, 32))[0]
            for k in (1, 2)))
    assert roofline.bound_s(launches, "forest")[0] == 1
