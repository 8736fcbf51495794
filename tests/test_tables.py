from gpu_video_codec_jax.ops.tables import BETA_TABLE, TC_TABLE, get_beta, get_tc


def test_table_lengths():
    assert len(BETA_TABLE) == 52
    assert len(TC_TABLE) == 52


def test_low_qp_noop_band():
    # beta == 0 for QP < 16 and tc == 0 for QP < 18 => filter is a no-op
    assert all(get_beta(qp) == 0 for qp in range(16))
    assert all(get_tc(qp) == 0 for qp in range(18))
    assert get_beta(16) == 6
    assert get_tc(18) == 1


def test_known_values():
    # spot values from cpu.h:1021-1033
    assert get_beta(35) == 32
    assert get_tc(35) == 4
    assert get_beta(51) == 64
    assert get_tc(51) == 20


def test_qp_clamped_above_51():
    # cpu.h:1065, 1070: QP > 51 clamps to the last entry
    assert get_beta(60) == get_beta(51)
    assert get_tc(100) == get_tc(51)
