"""Host milliseconds a window step spends in the compiled step's call
(train/step_graph.py: copy-in, replay, clone); the mean over the window's
steps."""


def read(run):
    return 1e3 * sum(run.step_s) / len(run.step_s) if run.step_s else None
