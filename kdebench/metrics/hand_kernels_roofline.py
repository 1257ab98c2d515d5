"""The hand kernels' share of their roofline over the traced stretch: the
least time their work could take (kernels/<family>.py's operations at
67 TFLOP/s f32 or bytes at 3.35 TB/s, the larger, counted on the
reference's intermediates of the stretch's frames) over their device time,
summed over the families the trace holds, in %."""


def read(run):
    if not run.kernels:
        return None
    device = sum(k["device_s"] for k in run.kernels.values())
    least = sum(k["least_s"] for k in run.kernels.values())
    return 100.0 * least / device if device > 0 else None
