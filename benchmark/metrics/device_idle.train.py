"""Share of the traced window with nothing on the device, train cells: one
minus the union of kernel and copy intervals over the window."""

from benchmark.metrics._shares import device_idle


def read(run):
    return device_idle(run, "train")
