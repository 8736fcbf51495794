"""HEVC deblocking threshold tables: QP -> beta and QP -> tC.

Reference parity: hevc_deblocking_filter_cpu.h:1021-1033 (beta_table, tc_table)
and cpu.h:1064-1072 (GetBeta/GetTc, clamped at QP 51).

Design note: Qp is a single scalar per frame, so beta/tC are looked
up once on the host and passed to kernels as int32 scalars -- there is no
reason to put a 52-entry LUT on the device (reference rebuilds the device-side
tables on every __device__ call, gpu.cu:79-101; we do the lookup exactly once).
"""

from __future__ import annotations

# QP 0..51. beta == 0 for QP < 16 and tC == 0 for QP < 18, which makes the
# whole deblocking filter a no-op at low QP (cond1 `< beta` can never hold,
# and every normal-filter row gate `|delta| < 10*tc` fails).
BETA_TABLE: tuple[int, ...] = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,          # QP 0..15
    6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,  # QP 16..31
    26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,  # QP 32..47
    58, 60, 62, 64,                                            # QP 48..51
)

TC_TABLE: tuple[int, ...] = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,          # QP 0..15
    0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3,           # QP 16..31
    3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13,        # QP 32..47
    14, 16, 18, 20,                                            # QP 48..51
)

# The 8x8 sample-block grid size everything in the pipeline is built around
# (reference: const int sample_block_size = 8, cpu.h:1035).
SAMPLE_BLOCK_SIZE = 8
HALF_BLOCK = SAMPLE_BLOCK_SIZE // 2
MAX_PIXEL = (1 << 8) - 1  # cpu.h:1202


def get_beta(qp: int) -> int:
    """QP -> beta threshold (cpu.h:1064-1067; QP clamped at 51)."""
    qp = int(qp)
    if qp < 0:
        raise ValueError(f"QP must be non-negative, got {qp}")
    return BETA_TABLE[min(qp, 51)]


def get_tc(qp: int) -> int:
    """QP -> tC threshold (cpu.h:1069-1072; QP clamped at 51)."""
    qp = int(qp)
    if qp < 0:
        raise ValueError(f"QP must be non-negative, got {qp}")
    return TC_TABLE[min(qp, 51)]
