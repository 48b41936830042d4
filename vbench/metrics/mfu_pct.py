"""mfu_pct: the least time the traced stretch's whole search work needs
(ADC, merges, rerank and lookup tables; the larger of its operations over
the H100's published float32 peak and its bytes over 3.35 TB/s,
``vbench/roofline.py``) over the traced stretch's wall time."""
from vbench import roofline


def read(run):
    w = run.traced_work()
    if w is None or run.trace is None or run.trace.busy_s <= 0 or run.trace.window_s <= 0:
        return None  # nothing ran on a device
    return 100.0 * roofline.search_ms(w, run.cell.cfg) / (run.trace.window_s * 1e3)
