"""pq_adc_roofline: the least time the traced stretch's ADC work needs
(``vbench/roofline.py``) over the device time of the ``pq_adc`` kernels in
the trace."""
from vbench import roofline


def read(run):
    w = run.traced_work()
    t = run.trace.kernel_s("adc_staged_kernel", "adc_l2_kernel", "adc_dense_kernel") \
        if run.trace is not None else 0.0
    if w is None or t <= 0:
        return None
    return 100.0 * roofline.bound(*roofline.adc_work(w, run.cell.cfg))[0] / (t * 1e3)
