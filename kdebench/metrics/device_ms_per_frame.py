"""Device milliseconds a frame: the union of the device activities'
intervals over the traced stretch of whole steps, over its frames."""


def read(run):
    st = run.stretch
    if st is None or run.traced_frames == 0 or st.busy_s <= 0:
        return None
    return st.busy_s * 1e3 / run.traced_frames
