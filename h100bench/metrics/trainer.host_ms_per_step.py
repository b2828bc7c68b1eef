"""Host milliseconds a window step spends in the trainer's calls
(data/loader.py): the next batch of the DataLoader's epoch, onehot_padded
and the two to_device copies; the mean over the window's steps."""


def read(run):
    return 1e3 * sum(run.trainer_s) / len(run.trainer_s) if run.trainer_s else None
