"""The least time the window's labels need on this card (``peaks.py``:
integer operations over the issue-rate ceiling; bytes only in and out,
ROMix's V being scratch), over the device time of every kernel in the
traced window, whatever its name."""

from benchmark import peaks
from benchmark.devtrace import busy_us, clip
from benchmark.stats import window_us


def read(run):
    if run.dtrace is None:
        return None
    lo, hi = window_us(run)
    kernel_s = busy_us(clip(run.dtrace.intervals("kernel"), lo, hi)) / 1e6
    labels = run.window_labels()
    least = peaks.label_least_s(labels, run.config["scrypt_n"],
                                run.device_kind)
    if least is None or kernel_s <= 0 or labels <= 0:
        return None
    return 100.0 * least / kernel_s
