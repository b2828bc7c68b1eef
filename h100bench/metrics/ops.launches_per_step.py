"""Kernels the device ran a traced step (every activity but copies and
fills)."""

from h100bench.categories import TRANSFERS


def read(run):
    st = run.stretch
    if st is None or not st.activities:
        return None
    return sum(1 for a in st.activities if a.category not in TRANSFERS) / st.steps
