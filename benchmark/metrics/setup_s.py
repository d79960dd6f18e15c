"""``setup_s``: seconds from the process's start to the first timed
decision: imports, the CUDA context, the kernels' load (built once per
checkout), the micro steps' warm-up, the link probe, the traffic's
draws, the fill and the plan-settling warm-up."""


def read(run):
    return run.setup_s
