"""Device milliseconds a traced step spends in the program's pool and
concat kernels (K8, by their symbols in pool_concat.py). Nothing when the
stretch ran none, as on a program without K8."""

from h100bench import pool_concat


def read(run):
    st = run.stretch
    if st is None or not any(pool_concat.is_k8(a.name) for a in st.activities):
        return None
    return pool_concat.device_us(st) / 1e3 / st.steps
