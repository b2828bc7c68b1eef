"""Device milliseconds a traced step spends in kernels of the program's
hand-written sources (K1-K6, by the symbol table of categories.py).
Nothing when the stretch ran none."""

from h100bench.categories import is_csrc


def read(run):
    st = run.stretch
    if st is None:
        return None
    mine = [a.dur_us for a in st.activities if is_csrc(a.category)]
    return sum(mine) / 1e3 / st.steps if mine else None
