"""The hand-written CUDA kernels and their wrappers.

Each wrapper adds one to its own launch count where it launches its kernel,
and nowhere else (a CPU tensor takes the plain version and counts nothing).
``launch_counts`` reads every count and ``reset_launch_counts`` sets them
to 0.
"""


def launch_counts() -> dict:
    """{kernel: launches}: K1, K2 (K1's record instance), K3 and its record
    and device-memory instances, the replay, K4, K5 (``K5_by_tree``: its
    launches by table kind) and the draws kernel (``draws``)."""
    from another_raytracer_tpu_torch.ops.kernels import (bvh_kernel,
                                                         mega_diff,
                                                         mega_kernel,
                                                         perlin_kernel,
                                                         threefry_kernel)

    mega = mega_kernel.trace_regenerative_mega
    return dict(K1=mega.launches, K2=mega.record_launches,
                K3=mega.accel_launches, K3_record=mega.accel_record_launches,
                K3_global=mega.accel_global_launches,
                K3_record_global=mega.accel_record_global_launches,
                replay=mega_diff.replay_backward.launches,
                K5=bvh_kernel.bvh_closest_hit.launches.total(),
                K5_by_tree=dict(bvh_kernel.bvh_closest_hit.launches),
                K4=perlin_kernel.perlin_noise.launches,
                draws=threefry_kernel.uniform2.launches)


def reset_launch_counts() -> None:
    """Every kernel's launch count (and K4's point count) to 0."""
    from another_raytracer_tpu_torch.ops.kernels import (bvh_kernel,
                                                         mega_diff,
                                                         mega_kernel,
                                                         perlin_kernel,
                                                         threefry_kernel)

    mega = mega_kernel.trace_regenerative_mega
    mega.launches = mega.record_launches = 0
    mega.accel_launches = mega.accel_record_launches = 0
    mega.accel_global_launches = mega.accel_record_global_launches = 0
    mega_diff.replay_backward.launches = 0
    bvh_kernel.bvh_closest_hit.launches.clear()
    perlin_kernel.perlin_noise.launches = 0
    perlin_kernel.perlin_noise.points = 0
    threefry_kernel.uniform2.launches = 0
