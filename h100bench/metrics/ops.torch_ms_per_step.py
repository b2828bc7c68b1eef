"""Device milliseconds a traced step spends in activities that are not
kernels of the program's hand-written sources (categories.py): PyTorch's
elementwise, copy and reduction kernels around the contractions, the
host-to-device copies and fills."""

from h100bench.categories import is_csrc


def read(run):
    st = run.stretch
    if st is None or not st.activities:
        return None
    return sum(a.dur_us for a in st.activities if not is_csrc(a.category)) / 1e3 / st.steps
