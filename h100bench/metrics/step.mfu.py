"""The window's share of the device's peak integer rate: the benchmark's
count of one step's contraction operations (work.py) times the steps
issued in the window, over the window's seconds and the peak (peaks.json,
by the device's name). Nothing without a known peak."""


def read(run):
    if run.peak_ops is None or not run.window_s:
        return None
    return 100.0 * run.step_ops * run.window_steps / run.window_s / run.peak_ops
