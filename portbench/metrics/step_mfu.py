"""step_mfu: percent of one H100's float64 peak (67 TFLOP/s) that the
window's counted operations (portbench.counts, per step) reach over its
seconds."""
from portbench import counts


def read(w):
    if not w.steps or w.window_s <= 0:
        return None
    return 100.0 * w.flops_per_step * w.steps / (w.window_s
                                                  * counts.F64_PEAK)
