"""Re-export of the golden oracle (SURVEY.md section 4 places it here; the
implementation lives in the package so it can double as the reference CPU
backend)."""

from gpu_video_codec_jax.models.golden import (  # noqa: F401
    apply_normal_filter,
    apply_strong_filter,
    check_local_adaptivity,
    chroma_filter_segment,
    clip1,
    clip2,
    deblock_frame_golden,
    is_strong_filter,
    luma_filter_segment,
)
