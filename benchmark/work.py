"""Roofline arithmetic: the published peaks of one H100 SXM and the work
a sweep render needs, counted from the scene and its segments.

The operations per segment were counted from the sweep megakernel's
source (``another_raytracer_tpu_torch/csrc/mega_kernel.cu``): a sphere
row's test, a rect row's test, and the rest of a segment (one 13-round
threefry call, direction sampling, shading and the carry's updates).  They
are frozen here so that no change to the program can change the yardstick:
the count is of the work the render needs, whatever kernel implements it.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM at 700 W: float32 outside the tensor cores,
# and HBM3 bandwidth.  Integer operations count at the float32 rate.
PEAK_OPS, PEAK_BYTES = 67e12, 3.35e12
OPS_SPHERE_ROW, OPS_RECT_ROW, OPS_SEGMENT = 30, 35, 144
ROW_BYTES = 32 * 4  # one primitive row of the sweep's table, float32
PIXEL_BYTES = 24  # a pixel's float32 radiance sum, read and written


def bound(ops: float, nbytes: float) -> tuple:
    """(least seconds at the card's peaks, "operations" or "bytes")."""
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def sweep_ops_per_segment(n_rects: int, n_spheres: int) -> int:
    """Operations of one segment that tests every row of the scene."""
    return n_rects * OPS_RECT_ROW + n_spheres * OPS_SPHERE_ROW + OPS_SEGMENT


def sweep_bound(segments: int, n_rects: int, n_spheres: int, width: int,
                height: int) -> tuple:
    """``bound`` of a sweep render of ``segments`` segments: every segment
    tests every row; the bytes are the image's sums and the row table."""
    return bound(segments * sweep_ops_per_segment(n_rects, n_spheres),
                 width * height * PIXEL_BYTES
                 + (n_rects + n_spheres) * ROW_BYTES)
