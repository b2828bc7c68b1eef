"""The step's contractions at their roofline, as a share of the device's
busy time: the sum over one step's contractions of the larger of their
operations over the peak rate and their bytes over the peak bandwidth
(work.py, peaks.json), over the busy union of a traced step. It reads the
same work whatever kernels implement it. Nothing without a known peak."""

from h100bench.trace import busy_us


def read(run):
    st = run.stretch
    if run.bound_s is None or st is None or not st.activities:
        return None
    return 100.0 * run.bound_s / (busy_us(st) / 1e6 / st.steps)
