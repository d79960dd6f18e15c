"""Hand-written CUDA kernels for Hopper and their wrappers."""


def launch_counts() -> dict:
    """Each kernel wrapper's launch counter in this process (all 0 where
    only the plain versions ran, as on the CPU)."""
    from ratelimiter_tpu_torch.ops.cuda import block_scatter, relay_step, solver

    return {"solver": solver.launches,
            "tb_writeback": block_scatter.tb_writeback_launches,
            "sw_writeback": block_scatter.sw_writeback_launches,
            "block_scatter": block_scatter.launches,
            "relay_step": relay_step.launches}
