from supnerf_tpu_torch.parallel.mesh import (  # noqa: F401
    COUNTS,
    Group,
    Plan,
    all_reduce_flat,
    all_reduce_sum,
    gather_to_main,
    is_main,
    launch,
    plan_launch,
    reset_counts,
    row_slice,
)
