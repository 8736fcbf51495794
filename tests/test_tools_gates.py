"""Experiment harnesses under tools/ that stay importable and correct."""


def test_chromafold_formulation_bitexact(monkeypatch):
    """The packed-chroma fold experiment must stay bit-equal to the
    production retile path: forward tiles, full layout round-trip, and
    identity on the region (tiny geometry)."""
    monkeypatch.setenv("GVCT_RELAYOUT", "mxu")  # the fold rides the mxu engine
    from tools.chromafold_exp import check

    r = check(geometries=((64, 48),))
    assert r["ok"], r
