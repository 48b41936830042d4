"""topk_select_roofline: the least time the traced stretch's merges, frontier
picks and cuts need (``vbench/roofline.py``) over the device time of the
``topk_select`` kernels in the trace."""
from vbench import roofline


def read(run):
    w = run.traced_work()
    t = run.trace.kernel_s("topk_") if run.trace is not None else 0.0
    if w is None or t <= 0:
        return None
    return 100.0 * roofline.bound(*roofline.topk_work(w, run.cell.cfg))[0] / (t * 1e3)
