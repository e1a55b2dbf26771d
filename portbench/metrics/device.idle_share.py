"""device.idle_share: the share of the traced window in which no operation
ran on the card, 1 - (union of the device operations' intervals / window).
The union, not the sum of durations, so overlapping kernels count once."""


def read(view):
    if not view.device_ops or view.window_us <= 0:
        return None
    return 1.0 - view.busy_us() / view.window_us
