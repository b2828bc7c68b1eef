"""The share of the traced stretch in which the device ran nothing: one
less the busy union over the span from the first activity's start to the
last one's end. It reads the program only in cells whose device step
outlasts the tracer's host cost, which launches a replayed graph kernel by
kernel (about 2 us a kernel) and can keep only a few thousand kernels
queued; BENCHMARK.json lists those cells."""

from h100bench.trace import busy_us, span_us


def read(run):
    st = run.stretch
    if st is None or not st.activities or span_us(st) <= 0:
        return None
    return 100.0 * (1.0 - busy_us(st) / span_us(st))
