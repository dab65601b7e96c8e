"""Operations and bytes of a stylized 3DGS inference frame, from the
frame's size and the live (splat, pixel) pairs and (64 px block, splat)
pairs the reference counts for the model and camera.

Operations run on the CUDA cores' float32 peak for the walk's bound; the
whole frame's share is of the TF32 peak, the fastest at which the card
multiplies float32 data.
"""

from __future__ import annotations

from portbench.roofline import peaks

SH_POINT_FLOPS = 3 * 16 * 2 + 40   # 16 basis terms x 3 channels, and the basis
PROJECT_POINT_FLOPS = 200          # covariance, Jacobian, conic, radius, mean
PAIR_FLOPS = 15   # a walk's float32 operations per (row, pixel), the exp as one
ROW_BYTES = 64    # one packed [16] float32 row of a block's list


def render_frame_work(h: int, w: int, live_pairs: int, block_pairs: int, active: int) -> dict:
    """An inference frame's operations (the view-dependent colour, the
    projection, the walk over the live pairs) and the walk's bound: the
    live pairs' operations, or each block's rows read once and the image
    written once."""
    return {
        "flops": active * (SH_POINT_FLOPS + PROJECT_POINT_FLOPS) + live_pairs * PAIR_FLOPS,
        "live_pairs": live_pairs,
        "composite_bound_s": peaks.bound_s(live_pairs * PAIR_FLOPS,
                                           block_pairs * ROW_BYTES + h * w * 3 * 4,
                                           peaks.FP32_FLOPS),
    }
