"""``train_clips_per_s``: training rows stepped over by the window's
``fit`` calls, times the epochs they ran, over the window's whole wall
time (each call's eager first epoch and capture included; the clock ends
after the last call's last host read)."""


def read(record):
    return record.n_train * record.epochs / record.window_s
